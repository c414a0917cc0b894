"""Time this checkout's warp and splat kernels against another checkout's, and
K1's bodies against each other, on one CUDA card.

Run from the repository root on the machine with the card::

    python -m comfyui_frame_interpolation_tpu_torch.utils.kernel_compare \\
        --parent build/parent [--out build/kernel_compare.json]

``--parent`` names the root of another checkout (for instance the parent
commit, unpacked with ``git archive``). Its ``csrc/warp.cu`` and
``csrc/softsplat.cu`` are built beside this checkout's, and each version is
timed in turns (old, new, new, old) in this one process, on the same tensors,
at the main paths' shapes. Each entry of the other checkout is bound by the
parameter list that its own source declares (:func:`entry_params`,
:class:`Entry`): a checkout whose entries take no row band and one whose
entries take ``hs``/``ho`` and ``row0`` after ``w`` (given the whole height
and 0) are called alike.

* K1 at RIFE's batch-8 1080p warps, ``[16, 1088, 1920, 7]`` and ``[16, 1088,
  1920, 3]`` bf16 with f32 and bf16 flow, and at M2M's batch-2 1080p warps
  ``[2, 544, 960, 48]`` and ``[8, 1088, 1920, 3]`` bf16 in zeros mode; and
  on NCHW planes ``[16, C, 1088, 1920]`` bf16 (C = 7, 3), a layout no main
  path passes. The old version is the other checkout's ``cfi_warp_bilinear``,
  the new one ``ops.warp.warp`` (the kernel its route picks). Both must agree
  bit for bit.
* K2 through the splat op (f32 zero fill, kernel, cast to the input dtype):
  at ``[16, 1088, 1920, 4]`` bf16 with smooth flow, and on the splat inputs
  of an M2M 1080p bf16 batch-2 forward with random weights from seed 0,
  whose flows are rough. Both must agree within one bf16 ulp of the largest
  output (M2M's weighted values cancel in the sums, so the check is relative
  to the output's scale).

* the wide kernel at every wide warp shape of the main paths, as one
  forward of each records them (FILM 1080p b2, M2M 1080p b2, GMFSS 1080p
  b1, STMFNet 1080p b1, IFRNet S 1080p b4, IFUnet 1080p b2, AMT-S 1080p b2,
  all bf16, and RIFE 4.0's Contextnet at 540x960 b2, bf16, fast mode off):
  each shape with the layout, dtypes and mode the path gives it, on random
  values and smooth flow (amplitude 6 px). The old version is the other
  checkout's ``cfi_warp_bilinear_wide``, the new one
  ``warp_kernel.warp_bilinear_wide``; both must agree bit for bit. Times are
  device ms from a ``torch.profiler`` trace (the host's launch cost, which
  would set the pace of the small shapes under CUDA events, left out), in
  turns, beside ``F.grid_sample``'s device ms on the same tensors and the
  bound; and per path, the sum over one forward's launches.

* the warp's backward kernel (``backward``): the other checkout's
  ``cfi_warp_bilinear_backward``, as its wrapper called it (an entry
  that takes ``cp``: a zeroed f32 buffer ``[N, H, W, Cp]`` and the vector
  widths; the first design's: a thread per pixel with scalar atomics into
  a zeroed NCHW f32 buffer, copied into the image's layout and dtype after
  the kernel) against ``warp_kernel.warp_bilinear_backward``, on ``channels_last``
  images and output gradients with smooth flow (amplitude 6 px), border
  mode: ``[32, 256, 256, 7]`` f32 and bf16 (the flow in the image's dtype,
  as the bf16 training step gives it), ``[32, 256, 256, 3]`` f32 without
  the image's gradient, ``[16, 1088, 1920, 7]`` f32; and on the four warps'
  inputs of one RIFE 4.7 training step at b16 x 256x256 f32 (random weights
  from seed 0), as the step hands them over. Each op in turns by CUDA
  events, and the kernel alone by device ms from a profile, in turns,
  beside ``aten.grid_sampler_2d_backward``'s device ms and the bound.
  Both must agree within ``chip_smoke.py`` phase 48's tolerances: the
  image's gradient within 1e-5 of each pixel's sum of absolute
  contributions plus 1e-6, the flow's within 1e-5 of its largest plus 1e-6,
  bf16 one ulp more.

* the splat's backward kernel (``splat_backward``): the other checkout's
  ``cfi_softsplat_backward`` (its outputs allocated as the wrapper does)
  against ``softsplat_kernel.softsplat_bilinear_backward``, at EISAI's
  ``[8, 128, 128, 66]`` f32 (smooth flow, amplitude 6 px) and at every
  distinct input one training step of each path hands the kernel
  (``chip_smoke.py:splat_backward_step_inputs``: M2M b8 x 256x256 f32 and
  bf16; GMFSS base and union, EISAI, XVFI and STMFNet at b8 x 256x256 f32),
  as the step hands it over. The input's gradient must be the same bits,
  the flow's within ``chip_smoke.py`` phase 52's tolerance (1e-5 of its
  largest plus 1e-6, bf16/f16 one ulp more). Each op in turns by CUDA
  events, and the kernel alone by device ms from a profile, in turns,
  beside the two library calls' device ms
  (``chip_smoke.py:splat_backward_library_call``) and the bound; and per
  step, the sums over its launches.

It also times K1 against the wide kernel at ``[4, 1088, 1920, C]``, C = 3 to
32 in bf16 and 3 to 8 in f32, the sweep that places the routing threshold
(``warp_kernel.WIDE_MIN_BYTES``). ``--sections`` picks the parts to run.

Every line printed names the card and its power limit; the numbers also go to
``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models import m2m
from ..ops.cuda import build, warp_kernel
from ..ops.cuda.build import DTYPE_CODES
from ..ops.softsplat import softsplat_func
from ..ops.warp import warp, warp_backward_torch

THRESHOLD_CHANNELS = {torch.bfloat16: (3, 4, 6, 7, 8, 10, 12, 14, 16, 24, 32), torch.float32: (3, 4, 6, 7, 8)}
SECTIONS = ("k1", "k2", "wide", "threshold", "backward", "splat_backward")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores, same source


def smooth_flow(b: int, h: int, w: int, amp: float, scale: float = 200.0) -> np.ndarray:
    """The smooth flow of ``tests/warp_cases.py``, ``[b, h, w, 2]`` f32."""
    gy, gx = np.mgrid[0:h, 0:w]
    base = np.stack(
        [amp * np.sin(gx / scale) + 0.5 * amp * np.cos(gy / scale), -amp * np.cos(gx / scale) + 0.4 * amp * np.sin(gy / scale)],
        axis=-1,
    ).astype(np.float32)
    return np.broadcast_to(base, (b, h, w, 2)).copy()


def ms(fn: Callable, iters: int) -> float:
    """Mean ms per call of ``fn()`` between CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(old: Callable, new: Callable, iters: int) -> Dict[str, float]:
    """old, new, new, old; the mean of each pair, and each time."""
    a = ms(old, iters)
    b = ms(new, iters)
    c = ms(new, iters)
    d = ms(old, iters)
    return {"old_ms": statistics.mean((a, d)), "new_ms": statistics.mean((b, c)), "old": [a, d], "new": [b, c]}


def device_ms(fn: Callable, iters: int, name: str) -> float:
    """Device ms of one call of ``fn()``, which launches one kernel whose
    name holds ``name``: the mean time of its launches in a
    ``torch.profiler`` trace of ``iters`` calls, after one warm-up (a trace
    of many short kernels may drop some; the mean of those it kept stays
    right)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace of a few short kernels now and then comes back empty: trace again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        on_device = [e for e in prof.key_averages() if str(getattr(e, "device_type", "")).endswith("CUDA") and name in e.key]
        total_us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0) for e in on_device)
        if total_us > 0:
            return total_us / 1e3 / sum(e.count for e in on_device)
    raise RuntimeError(f"device_ms: three profiler traces saw no device time in {name}")


def warp_bound_ms(planes: torch.Tensor, flow_planes: torch.Tensor) -> Tuple[float, str]:
    """The least ms the card could take for one warp: the image and flow read
    once and the output written once over the memory rate, or 7 f32
    operations a channel and 14 a pixel over the f32 rate, whichever is
    larger."""
    n, c, h, w = planes.shape
    nbytes = 2 * planes.numel() * planes.element_size() + flow_planes.numel() * flow_planes.element_size()
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * n * h * w * (7 * c + 14) / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the C types of the entries' parameters, as ctypes binds them (pointers and
# the stream as c_void_p: ctypes would cut them to 32 bits)
C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int, "int64_t": ctypes.c_int64}
# the file of csrc/ that defines each entry this module binds
ENTRY_SOURCES = {
    "cfi_warp_bilinear": "warp.cu",
    "cfi_warp_bilinear_wide": "warp.cu",
    "cfi_warp_bilinear_backward": "warp.cu",
    "cfi_softsplat": "softsplat.cu",
    "cfi_softsplat_backward": "softsplat.cu",
}


def entry_params(source: str, name: str) -> List[Tuple[str, str]]:
    """``(C type, name)`` of each parameter of ``extern "C" int name(...)``
    in the text of a ``.cu`` file."""
    m = re.search(r'extern\s+"C"\s+int\s+' + re.escape(name) + r"\s*\(([^)]*)\)", source)
    if m is None:
        raise ValueError(f'no extern "C" int {name}(...) in the source')
    params = []
    for decl in m.group(1).split(","):
        decl = " ".join(decl.replace("*", "* ").split())
        ctype, _, pname = decl.rpartition(" ")
        params.append((ctype.replace(" *", "*"), pname))
    return params


class Entry:
    """A C entry point bound by its own parameter list (:func:`entry_params`):
    called with each parameter's value by name. ``hs`` and ``ho`` (the
    source's or the output's rows, which an entry that takes a row band
    takes) default to ``h`` and ``row0`` to 0, the whole frame; an entry
    that lacks them is called without them."""

    def __init__(self, name: str, params: List[Tuple[str, str]], fn: Callable):
        unknown = [t for t, _ in params if t not in C_TYPES]
        if unknown:
            raise ValueError(f"{name}: parameters of C types {unknown} that this module cannot bind")
        self.name, self.params, self.fn = name, params, fn

    @property
    def argtypes(self) -> list:
        return [C_TYPES[t] for t, _ in self.params]

    def takes(self, pname: str) -> bool:
        return any(n == pname for _, n in self.params)

    def arguments(self, values: Dict) -> list:
        """The positional arguments of a call with ``values`` by name."""
        defaults = {"hs": values.get("h"), "ho": values.get("h"), "row0": 0}
        args = []
        for _, pname in self.params:
            if pname in values:
                args.append(values[pname])
            elif pname in defaults:
                args.append(defaults[pname])
            else:
                raise TypeError(f"{self.name}: no value for its parameter {pname}")
        return args

    def __call__(self, **values) -> int:
        return self.fn(*self.arguments(values))


def bind(lib: ctypes.CDLL, csrc: str, name: str) -> Entry:
    """``name`` of ``lib``, built from the ``csrc/`` directory ``csrc``,
    bound by the parameter list that its source there declares."""
    with open(os.path.join(csrc, ENTRY_SOURCES[name])) as f:
        params = entry_params(f.read(), name)
    fn = getattr(lib, name)
    entry = Entry(name, params, fn)
    fn.restype = ctypes.c_int
    fn.argtypes = entry.argtypes
    return entry


def strides(prefix: str, t: torch.Tensor, dims: str = "nchw") -> Dict[str, int]:
    """``{prefix_n: ..., prefix_c: ..., ...}``: ``t``'s strides by the
    entries' parameter names (``dims`` of ``nchw``)."""
    return {f"{prefix}_{d}": t.stride("nchw".index(d)) for d in dims}


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def call_warp(fn: Entry, img: torch.Tensor, flow: torch.Tensor, zeros: bool) -> torch.Tensor:
    """``fn`` (a ``cfi_warp_bilinear`` entry) on NHWC ``img``/``flow``."""
    planes, fplanes = img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)
    out = torch.empty_like(planes)
    n, c, h, w = planes.shape
    rc = fn(
        img=planes.data_ptr(), flow=fplanes.data_ptr(), out=out.data_ptr(), img_dtype=DTYPE_CODES[img.dtype],
        flow_dtype=DTYPE_CODES[flow.dtype], zeros=int(zeros), n=n, c=c, h=h, w=w,
        **strides("si", planes), **strides("sf", fplanes), **strides("so", out), stream=_stream(),
    )
    if rc != 0:
        raise RuntimeError(f"warp launch returned {rc}")
    return out.permute(0, 2, 3, 1)


def call_splat(fn: Entry, vals: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The splat op around ``fn`` (a ``cfi_softsplat`` entry): zero fill,
    kernel, cast, as ``ops.softsplat.softsplat_func`` does."""
    planes, fplanes = vals.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)
    out = torch.zeros_like(planes, dtype=torch.float32)
    n, c, h, w = planes.shape
    rc = fn(**{
        "in": planes.data_ptr(), "flow": fplanes.data_ptr(), "out": out.data_ptr(), "in_dtype": DTYPE_CODES[vals.dtype],
        "flow_dtype": DTYPE_CODES[flow.dtype], "n": n, "c": c, "h": h, "w": w,
        **strides("si", planes), **strides("sf", fplanes), **strides("so", out), "stream": _stream(),
    })
    if rc != 0:
        raise RuntimeError(f"splat launch returned {rc}")
    return out.permute(0, 2, 3, 1).to(vals.dtype)


def call_wide(fn: Entry, planes: torch.Tensor, fplanes: torch.Tensor, zeros: bool) -> torch.Tensor:
    """``fn`` (a ``cfi_warp_bilinear_wide`` entry: channel stride 1, so no
    channel strides of the image and the output) on ``[N, C, H, W]``
    planes, into a new ``channels_last`` tensor, as
    ``warp_kernel.warp_bilinear_wide`` calls it (with its one copy of planes
    whose channels are not contiguous)."""
    if planes.shape[1] > 1 and planes.stride(1) != 1:
        planes = planes.contiguous(memory_format=torch.channels_last)
    out = torch.empty(planes.shape, dtype=planes.dtype, device=planes.device, memory_format=torch.channels_last)
    n, c, h, w = planes.shape
    rc = fn(
        img=planes.data_ptr(), flow=fplanes.data_ptr(), out=out.data_ptr(), img_dtype=DTYPE_CODES[planes.dtype],
        flow_dtype=DTYPE_CODES[fplanes.dtype], zeros=int(zeros), n=n, c=c, h=h, w=w,
        **strides("si", planes, "nhw"), **strides("sf", fplanes), **strides("so", out, "nhw"), stream=_stream(),
    )
    if rc != 0:
        raise RuntimeError(f"wide warp launch returned {rc}")
    return out


def grid_sample_planes(planes: torch.Tensor, fplanes: torch.Tensor, zeros: bool) -> Callable:
    """``F.grid_sample`` computing the same warp of ``planes`` on a
    precomputed grid (the library yardstick; the port never calls it)."""
    import torch.nn.functional as F

    n, _, h, w = planes.shape
    gx = torch.arange(w, device=planes.device, dtype=torch.float32).view(1, 1, w) + fplanes[:, 0].float()
    gy = torch.arange(h, device=planes.device, dtype=torch.float32).view(1, h, 1) + fplanes[:, 1].float()
    grid = torch.stack([gx * (2.0 / max(w - 1, 1)) - 1.0, gy * (2.0 / max(h - 1, 1)) - 1.0], -1).to(planes.dtype)
    mode = "zeros" if zeros else "border"
    return lambda: F.grid_sample(planes, grid, mode="bilinear", padding_mode=mode, align_corners=True)


def wide_paths(dev) -> Dict[str, Tuple[int, Tuple[int, int], bool, Callable]]:
    """``{path: (batch, (H, W), takes a window of 4 frames, make model_fn)}``:
    the main paths that launch the wide kernel, at their timed sizes, bf16."""
    from ..models import amt, film, gmfss, ifrnet, ifunet, rife, stmfnet

    bf16 = torch.bfloat16
    return {
        "film 1080p b2": (2, (1080, 1920), False, lambda: film.make_model_fn(film.init_params(0), dtype=bf16, device=dev)),
        "m2m 1080p b2": (2, (1080, 1920), False, lambda: m2m.make_model_fn(m2m.init_params(0), dtype=bf16, device=dev)),
        "gmfss 1080p b1": (1, (1080, 1920), False, lambda: gmfss.make_model_fn(gmfss.init_params(0), dtype=bf16, device=dev)),
        "stmfnet 1080p b1": (1, (1080, 1920), True, lambda: stmfnet.make_model_fn(stmfnet.init_params(0), dtype=bf16, device=dev)),
        "ifrnet_s 1080p b4": (4, (1080, 1920), False, lambda: ifrnet.make_model_fn(ifrnet.init_params("S", 0), "S", dtype=bf16, device=dev)),
        "ifunet 1080p b2": (2, (1080, 1920), False, lambda: ifunet.make_model_fn(ifunet.init_params(0), dtype=bf16, device=dev)),
        "amt_s 1088x1920 b2": (2, (1088, 1920), False, lambda: amt.make_model_fn(amt.init_params("S", 0), "amt-s.pth", dtype=bf16, device=dev)),
        "rife40 540p b2 refined": (2, (540, 960), False, lambda: rife.make_model_fn(
            rife.init_params(0, "4.0"), "4.0", fastmode=False, dtype=bf16, device=dev)),
    }


def path_wide_warps(dev) -> Dict[tuple, Dict]:
    """One forward of each of :func:`wide_paths` with the wide kernel's
    wrapper spied on: ``{(NHWC shape, planes' strides, start offset mod 16
    bytes in elements, dtype, flow strides, flow dtype, zeros): {"paths":
    {path: launches per forward}}}``."""
    found: Dict[tuple, Dict] = {}
    real = warp_kernel.warp_bilinear_wide
    for path, (n, hw, window, make) in wide_paths(dev).items():
        fn = make()
        frames = [torch.from_numpy(np.random.default_rng(i).random((n, *hw, 3), dtype=np.float32)).to(dev)
                  for i in range(4 if window else 2)]
        args = frames if window else (*frames, torch.full((n,), 0.5, device=dev))

        def spy(img, flow, zeros=False, path=path):
            key = ((img.shape[0], img.shape[2], img.shape[3], img.shape[1]), tuple(img.stride()),
                   img.data_ptr() % 16 // img.element_size(), img.dtype, tuple(flow.stride()), flow.dtype, bool(zeros))
            per = found.setdefault(key, {"paths": {}})["paths"]
            per[path] = per.get(path, 0) + 1
            return real(img, flow, zeros)

        warp_kernel.warp_bilinear_wide = spy
        try:
            with torch.no_grad():
                fn(*args)
            torch.cuda.synchronize()
        finally:
            warp_kernel.warp_bilinear_wide = real
        del fn, frames, args
        torch.cuda.empty_cache()
    return found


def strided_like(shape, strides, offset: int, dtype, dev, values: torch.Tensor) -> torch.Tensor:
    """``values`` copied into a new tensor of ``shape`` and ``strides`` that
    starts ``offset`` elements into a fresh (512-byte aligned) buffer."""
    span = 1 + sum((n - 1) * st for n, st in zip(shape, strides))
    buf = torch.empty(span + offset, dtype=dtype, device=dev)
    return buf.as_strided(shape, strides, offset).copy_(values)


def wide_section(dev, old_fn: Callable, card: str) -> Dict:
    """The wide kernel, old and new, at each main-path wide shape."""
    found = path_wide_warps(dev)
    shapes, per_path = {}, {}
    g = torch.Generator(device=dev).manual_seed(5)
    for (shape, strides, offset, dtype, fstrides, fdtype, zeros), rec in sorted(found.items(), key=lambda kv: -np.prod(kv[0][0])):
        n, h, w, c = shape
        values = torch.rand((n, c, h, w), generator=g, device=dev).to(dtype)
        planes = strided_like((n, c, h, w), strides, offset, dtype, dev, values)
        flow = torch.from_numpy(smooth_flow(n, h, w, 6.0)).to(dev, fdtype).permute(0, 3, 1, 2)
        fplanes = strided_like((n, 2, h, w), fstrides, 0, fdtype, dev, flow)
        del values
        old = call_wide(old_fn, planes, fplanes, zeros)
        new = warp_kernel.warp_bilinear_wide(planes, fplanes, zeros)
        torch.cuda.synchronize()
        key = f"{list(shape)} {str(dtype).split('.')[-1]} {'zeros' if zeros else 'border'}, {str(fdtype).split('.')[-1]} flow"
        if not torch.equal(old, new):
            raise SystemExit(f"wide {key}: the new kernel differs from the old one")
        del old, new
        iters = 20
        wide = "warp_bilinear_wide_kernel"
        turns = [device_ms(lambda: call_wide(old_fn, planes, fplanes, zeros), iters, wide)]
        turns += [device_ms(lambda: warp_kernel.warp_bilinear_wide(planes, fplanes, zeros), iters, wide) for _ in range(2)]
        turns.append(device_ms(lambda: call_wide(old_fn, planes, fplanes, zeros), iters, wide))
        gs = device_ms(grid_sample_planes(planes, fplanes, zeros), iters, "grid_sampler")
        b = warp_bound_ms(planes, fplanes)
        t = {
            "old_ms": statistics.mean((turns[0], turns[3])), "new_ms": statistics.mean(turns[1:3]),
            "old": [turns[0], turns[3]], "new": turns[1:3], "grid_sample_ms": gs, "bound_ms": b[0], "bound_by": b[1],
            "paths": rec["paths"], "contiguous_nhwc": planes.is_contiguous(memory_format=torch.channels_last),
        }
        shapes[key] = t
        for path, count in rec["paths"].items():
            pp = per_path.setdefault(path, {"launches": 0, "old_ms": 0.0, "new_ms": 0.0, "bound_ms": 0.0, "grid_sample_ms": 0.0})
            pp["launches"] += count
            for k in ("old_ms", "new_ms", "bound_ms", "grid_sample_ms"):
                pp[k] += count * t[k]
        print(
            f"wide {card}: {key} ({', '.join(f'{p} x{k}' for p, k in rec['paths'].items())}): device ms old "
            f"{t['old_ms']:.4f} {t['old']}, new {t['new_ms']:.4f} {t['new']}, {t['old_ms'] / t['new_ms']:.2f}x; "
            f"grid_sample {gs:.4f}; bound {b[0]:.4f} ({b[1]}), new at {100 * b[0] / t['new_ms']:.1f} % of it; bit-exact",
            flush=True,
        )
        del planes, fplanes, flow
    for path, pp in per_path.items():
        print(
            f"wide {card}: per forward of {path}: {pp['launches']} launches, device ms old {pp['old_ms']:.4f}, new "
            f"{pp['new_ms']:.4f}, grid_sample {pp['grid_sample_ms']:.4f}, bound {pp['bound_ms']:.4f}",
            flush=True,
        )
    return {"by_shape": shapes, "per_forward": per_path}


def warp_cases(dev) -> List[Tuple[str, torch.Tensor, torch.Tensor, bool]]:
    g = torch.Generator().manual_seed(0)
    cases = []
    for c in (7, 3):
        img = torch.rand(16, 1088, 1920, c, generator=g).to(dev, torch.bfloat16)
        flow = torch.from_numpy(smooth_flow(16, 1088, 1920, 6.0)).to(dev)
        cases.append((f"rife [16,1088,1920,{c}] bf16, f32 flow", img, flow, False))
        cases.append((f"rife [16,1088,1920,{c}] bf16, bf16 flow", img, flow.to(torch.bfloat16), False))
    img = torch.rand(2, 544, 960, 48, generator=g).to(dev, torch.bfloat16)
    cases.append(("m2m [2,544,960,48] bf16 zeros", img, torch.from_numpy(smooth_flow(2, 544, 960, 6.0)).to(dev), True))
    img = torch.rand(8, 1088, 1920, 3, generator=g).to(dev, torch.bfloat16)
    cases.append(("m2m [8,1088,1920,3] bf16 zeros", img, torch.from_numpy(smooth_flow(8, 1088, 1920, 6.0)).to(dev), True))
    for c in (7, 3):  # NHWC views of NCHW planes: channel stride H*W
        img = torch.rand(16, c, 1088, 1920, generator=g).to(dev, torch.bfloat16).permute(0, 2, 3, 1)
        cases.append((f"nchw planes [16,{c},1088,1920] bf16, f32 flow", img, cases[0][2], False))
    return cases


def call_backward_old(fn: Entry, planes, fplanes, gplanes, zeros: bool, img_grad: bool = True):
    """The other checkout's backward op around ``fn`` (its
    ``cfi_warp_bilinear_backward``) on ``[N, C, H, W]`` planes, as its
    wrapper called it. An entry that takes ``cp``: a zeroed f32 buffer
    ``[N, H, W, Cp]``, the vector widths of ``warp_kernel.vector_bytes``,
    its ``[..., :C]`` view back for an f32 image and one cast for another
    dtype. The first design's (the image gradient's four strides instead): a zeroed NCHW f32 buffer, the kernel, one copy into
    the image's layout and dtype (none for a contiguous f32 image)."""
    n, c, h, w = planes.shape
    gf = torch.empty_like(fplanes)
    values = dict(
        img=planes.data_ptr(), flow=fplanes.data_ptr(), grad_out=gplanes.data_ptr(), grad_flow=gf.data_ptr(),
        img_dtype=DTYPE_CODES[planes.dtype], flow_dtype=DTYPE_CODES[fplanes.dtype], zeros=int(zeros), n=n, c=c, h=h, w=w,
        **strides("si", planes), **strides("sf", fplanes), **strides("sg", gplanes), **strides("sgf", gf), stream=_stream(),
    )
    if fn.takes("cp"):
        cp = warp_kernel.padded_channels(c)
        buf = torch.zeros((n, h, w, cp), dtype=torch.float32, device=planes.device) if img_grad else None
        isz = planes.element_size()
        values.update(
            grad_img=0 if buf is None else buf.data_ptr(), cp=cp,
            vec_img=warp_kernel.vector_bytes(c, planes.stride(), isz, planes.data_ptr()),
            vec_grad=warp_kernel.vector_bytes(c, gplanes.stride(), isz, gplanes.data_ptr()),
        )
    else:
        buf = torch.zeros((n, c, h, w), dtype=torch.float32, device=planes.device) if img_grad else None
        values.update(grad_img=0 if buf is None else buf.data_ptr(),
                      **(strides("sgi", buf) if buf is not None else dict.fromkeys(("sgi_n", "sgi_c", "sgi_h", "sgi_w"), 0)))
    rc = fn(**values)
    if rc != 0:
        raise RuntimeError(f"backward launch returned {rc}")
    if buf is None:
        return None, gf
    gi = buf[..., :c].permute(0, 3, 1, 2) if fn.takes("cp") else buf
    if planes.dtype != torch.float32 or not (fn.takes("cp") or planes.is_contiguous()):
        gi = torch.empty_like(planes).copy_(gi)
    return gi, gf


def backward_bound_ms(planes: torch.Tensor, fplanes: torch.Tensor, img_grad: bool) -> Tuple[float, str]:
    """The least ms the card could take for one warp backward: the output's
    gradient, the image and the flow read once, the flow's gradient and
    (with ``img_grad``) the image's written once in their dtypes, over the
    memory rate; or 22 f32 operations a channel and 40 a pixel over the f32
    rate, whichever is larger (``chip_smoke.py:backward_work``)."""
    n, c, h, w = planes.shape
    fbytes = fplanes.numel() * fplanes.element_size()
    nbytes = (3 if img_grad else 2) * planes.numel() * planes.element_size() + 2 * fbytes
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * n * h * w * (22 * c + 40) / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def backward_agreement(new, old, planes, fplanes, gplanes, zeros: bool) -> Tuple[float, float]:
    """The max abs differences of the new and old ``(grad_img, grad_flow)``
    (``grad_img`` None without the image's gradient); raises where they
    differ by more than phase 48's tolerances (the module's head)."""
    nhwc = lambda x: x.permute(0, 2, 3, 1)  # noqa: E731
    mode = "zeros" if zeros else "border"
    errs = []
    if new[0] is not None:
        contributions, _ = warp_backward_torch(nhwc(planes).float(), nhwc(fplanes).float(), nhwc(gplanes).float().abs(), mode)
        pairs = [(new[0], old[0], 1e-5 * contributions.permute(0, 3, 1, 2) + 1e-6, planes.dtype)]
    else:
        pairs = []
    scale = old[1].float().abs().max().item()
    pairs.append((new[1], old[1], 1e-5 * scale + 1e-6, fplanes.dtype))
    for got, ref, tol, dtype in pairs:
        g, r = got.float(), ref.float()
        if dtype in (torch.bfloat16, torch.float16):
            _, exp = torch.frexp(r.abs())
            tol = tol + torch.ldexp(torch.ones_like(r), exp - (8 if dtype == torch.bfloat16 else 11))
        err = (g - r).abs()
        if not bool((err <= tol).all()):
            raise SystemExit(f"backward {list(planes.shape)}: the new kernel differs from the old one by {err.max().item()}")
        errs.append(err.max().item())
    return (errs[0], errs[1]) if new[0] is not None else (0.0, errs[0])


def training_backward_inputs(dev) -> List[Tuple]:
    """The four backward launches' inputs of one RIFE 4.7 training step at
    b16 x 256x256 f32 (random weights from seed 0, Adam 1e-4), as the step
    hands them to ``warp_bilinear_backward``: ``[(img, flow, grad_out,
    zeros, img_grad)]``, cloned with their strides."""
    from .. import parallel
    from ..models import rife

    net = rife.IFNet("4.7")
    net.load_state_dict(rife.init_params(0, "4.7"))
    net = net.to(dev, memory_format=torch.channels_last)
    scale_list = rife.default_scale_list("4.7")
    step = parallel.make_train_step(
        lambda n, f0, f1, t: rife.apply(n, f0, f1, t, scale_list), torch.optim.Adam(net.parameters(), lr=1e-4),
        parallel.make_mesh(1, devices=[dev]), net,
    )
    rng = np.random.default_rng(50)
    f0, f1, target = (torch.from_numpy(rng.random((16, 256, 256, 3), dtype=np.float32)).to(dev) for _ in range(3))
    t = torch.from_numpy(rng.uniform(0.1, 0.9, 16).astype(np.float32)).to(dev)
    captured = []
    real = warp_kernel.warp_bilinear_backward

    def keep(x):
        if 0 in x.stride():  # an expanded gradient: no elements of its own to copy
            return x
        return torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=x.device).copy_(x)

    def capture(img, flow, grad_out, zeros=False, img_grad=True, row0=0):
        # one device: WarpFunction passes the whole frame's row0 = 0
        captured.append((keep(img), keep(flow), keep(grad_out), zeros, img_grad))
        return real(img, flow, grad_out, zeros, img_grad, row0=row0)

    warp_kernel.warp_bilinear_backward = capture
    try:
        step(f0, f1, t, target)
        torch.cuda.synchronize()
    finally:
        warp_kernel.warp_bilinear_backward = real
    return captured


def backward_section(dev, old_fn: Callable, card: str) -> Dict:
    """The backward op and kernel, old and new, in turns (the module's head)."""
    g = torch.Generator().manual_seed(7)
    cases = []
    for shape, dtype, img_grad in (
        ((32, 256, 256, 7), torch.float32, True), ((32, 256, 256, 7), torch.bfloat16, True),
        ((32, 256, 256, 3), torch.float32, False), ((16, 1088, 1920, 7), torch.float32, True),
    ):
        img = torch.rand(shape, generator=g).to(dev, dtype)
        grad_out = (torch.rand(shape, generator=g) * 2 - 1).to(dev, dtype)
        flow = torch.from_numpy(smooth_flow(*shape[:3], 6.0)).to(dev, dtype)
        key = f"{list(shape)} {str(dtype).split('.')[-1]} border, smooth flow" + ("" if img_grad else ", no image gradient")
        cases.append((key, img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2), grad_out.permute(0, 3, 1, 2), False, img_grad))
    for i, (img, flow, grad_out, zeros, img_grad) in enumerate(training_backward_inputs(dev)):
        key = f"training step warp {i}: {list(img.shape)} {str(img.dtype).split('.')[-1]}" + ("" if img_grad else ", no image gradient")
        cases.append((key, img, flow, grad_out, zeros, img_grad))
    result = {}
    name = "warp_bilinear_backward_kernel"
    for key, planes, fplanes, gplanes, zeros, img_grad in cases:
        old = lambda: call_backward_old(old_fn, planes, fplanes, gplanes, zeros, img_grad)  # noqa: E731
        new = lambda: warp_kernel.warp_bilinear_backward(planes, fplanes, gplanes, zeros, img_grad)  # noqa: E731
        errs = backward_agreement(new(), old(), planes, fplanes, gplanes, zeros)
        torch.cuda.synchronize()
        iters = 5 if planes.numel() > 1e8 else 20
        t = in_turns(old, new, iters)
        turns = [device_ms(fn, iters, name) for fn in (old, new, new, old)]
        nhwc = lambda x: x.permute(0, 2, 3, 1)  # noqa: E731
        lib = device_ms(
            library_backward(nhwc(planes), nhwc(fplanes), nhwc(gplanes), zeros, img_grad), iters, "grid_sampler_2d_backward"
        )
        b = backward_bound_ms(planes, fplanes, img_grad)
        t.update({
            "old_device_ms": statistics.mean((turns[0], turns[3])), "new_device_ms": statistics.mean(turns[1:3]),
            "old_device": [turns[0], turns[3]], "new_device": turns[1:3], "library_device_ms": lib,
            "bound_ms": b[0], "bound_by": b[1], "max_abs_diff": list(errs),
            "strides": [list(planes.stride()), list(fplanes.stride()), list(gplanes.stride())],
        })
        result[key] = t
        print(
            f"backward {card}: {key}: op old {t['old_ms']:.4f} ms {t['old']}, new {t['new_ms']:.4f} ms {t['new']}, "
            f"{t['old_ms'] / t['new_ms']:.2f}x; kernel on the device old {t['old_device_ms']:.4f} {t['old_device']}, new "
            f"{t['new_device_ms']:.4f} {t['new_device']}; grid_sampler_2d_backward {lib:.4f} on the device; bound {b[0]:.4f} "
            f"({b[1]}), the new op at {100 * b[0] / t['new_ms']:.1f} % of it; max diff (grad_img, grad_flow) "
            f"{errs[0]:.3g}, {errs[1]:.3g}",
            flush=True,
        )
        del planes, fplanes, gplanes
    return result


def library_backward(img, flow, grad_out, zeros: bool, img_grad: bool = True, row0: int = 0) -> Callable:
    """``aten.grid_sampler_2d_backward`` computing the warp's gradients of
    NHWC ``img`` by ``flow`` for ``grad_out`` on a precomputed grid (the
    grid's alone without ``img_grad``; with ``row0``, a row band's: the
    flow's and ``grad_out``'s rows are the source's ``row0`` on): the
    library yardstick, which the port never calls."""
    planes, gplanes = img.permute(0, 3, 1, 2), grad_out.permute(0, 3, 1, 2)
    n, _, h, w = planes.shape
    rows = flow.shape[1]
    gx = torch.arange(w, device=img.device, dtype=torch.float32).view(1, 1, w) + flow[..., 0].float()
    gy = torch.arange(row0, row0 + rows, device=img.device, dtype=torch.float32).view(1, rows, 1) + flow[..., 1].float()
    grid = torch.stack([gx * (2.0 / max(w - 1, 1)) - 1.0, gy * (2.0 / max(h - 1, 1)) - 1.0], -1).to(img.dtype)
    return lambda: torch.ops.aten.grid_sampler_2d_backward(gplanes, planes, grid, 0, 0 if zeros else 1, True, [img_grad, True])


def library_splat(vals, flow, row0: int = 0, out_rows: Optional[int] = None) -> Callable:
    """``aten.grid_sampler_2d_backward`` computing K2's splat of NHWC
    ``vals`` by ``flow`` on a precomputed grid: the input's gradient of a
    bilinear, zeros-padded ``grid_sample`` whose output's gradient is
    ``vals`` is the sum splat of ``vals`` at the grid's targets, corners off
    the frame dropped. The grid takes the targets as ``ops.softsplat``'s
    twin does (non-finite ones off the frame, the rest clamped to +-2w /
    +-2h) and the values are f32 (the call takes one dtype; K2 sums in f32
    too). The call returns ``[N, C, H, W]`` f32 planes; for K2's band
    (``row0``, ``out_rows``: ``vals`` the rows from ``row0`` of a frame of
    ``out_rows``) the band's part of the frame's splat, ``[N, C, out_rows,
    W]``. The library yardstick, which the port never calls."""
    planes = vals.permute(0, 3, 1, 2).float()
    n, c, h, w = planes.shape
    ho = h if out_rows is None else out_rows
    gx = torch.arange(w, device=vals.device, dtype=torch.float32).view(1, 1, w) + flow[..., 0].float()
    gy = (torch.arange(h, device=vals.device, dtype=torch.float32) + row0).view(1, h, 1) + flow[..., 1].float()
    finite = torch.isfinite(gx) & torch.isfinite(gy)
    gx = torch.where(finite, gx, -2.0 * w).clamp(-2.0 * w, 2.0 * w)
    gy = torch.where(finite, gy, -2.0 * ho).clamp(-2.0 * ho, 2.0 * ho)
    grid = torch.stack([gx * (2.0 / max(w - 1, 1)) - 1.0, gy * (2.0 / max(ho - 1, 1)) - 1.0], -1)
    zeros = torch.zeros((n, c, ho, w), dtype=torch.float32, device=vals.device)
    return lambda: torch.ops.aten.grid_sampler_2d_backward(planes, zeros, grid, 0, 0, True, [True, False])[0]


def call_splat_backward(fn: Entry, planes, fplanes, gplanes, in_grad: bool = True):
    """``fn`` (a ``cfi_softsplat_backward`` entry) on ``[N, C, H, W]``
    planes, its outputs allocated as ``softsplat_kernel.softsplat_bilinear_backward``
    allocates them: ``(grad_in or None, grad_flow)``."""
    gi = torch.empty_like(planes) if in_grad else None
    gf = torch.empty_like(fplanes)
    n, c, h, w = planes.shape
    rc = fn(**{
        "in": planes.data_ptr(), "flow": fplanes.data_ptr(), "grad_out": gplanes.data_ptr(),
        "grad_in": None if gi is None else gi.data_ptr(), "grad_flow": gf.data_ptr(), "in_dtype": DTYPE_CODES[planes.dtype],
        "flow_dtype": DTYPE_CODES[fplanes.dtype], "n": n, "c": c, "h": h, "w": w,
        **strides("si", planes), **strides("sf", fplanes), **strides("sg", gplanes),
        **(strides("sgi", gi) if gi is not None else dict.fromkeys(("sgi_n", "sgi_c", "sgi_h", "sgi_w"), 0)),
        **strides("sgf", gf), "stream": _stream(),
    })
    if rc != 0:
        raise RuntimeError(f"splat backward launch returned {rc}")
    return gi, gf


def splat_backward_section(dev, old_fn: Callable, card: str) -> Dict:
    """The splat's backward op and kernel, old and new, in turns (the
    module's head)."""
    from ..ops.cuda import softsplat_kernel

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    import chip_smoke

    nhwc = lambda x: x.permute(0, 2, 3, 1)  # noqa: E731
    g = torch.Generator().manual_seed(17)
    shape = (8, 128, 128, 66)
    vals = torch.rand(shape, generator=g).to(dev)
    flow = torch.from_numpy(smooth_flow(*shape[:3], 6.0)).to(dev)
    grad_out = (torch.rand(shape, generator=g) * 2 - 1).to(dev)
    eisai_key = f"{list(shape)} float32, smooth flow (EISAI's C = 66 at b8 x 256x256)"
    cases = {eisai_key: (vals.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2), grad_out.permute(0, 3, 1, 2), True)}
    layouts, per_step = chip_smoke.splat_backward_step_inputs(dev)
    cases.update(layouts)
    result = {"by_layout": {}, "per_step": {}}
    for key, (planes, fplanes, gplanes, in_grad) in cases.items():
        old = lambda: call_splat_backward(old_fn, planes, fplanes, gplanes, in_grad)  # noqa: E731
        new = lambda: softsplat_kernel.softsplat_bilinear_backward(planes, fplanes, gplanes, in_grad)  # noqa: E731
        (gi_new, gf_new), (gi_old, gf_old) = new(), old()
        torch.cuda.synchronize()
        if in_grad and not torch.equal(gi_new, gi_old):
            raise SystemExit(f"splat backward {key}: the new kernel's grad_in differs from the old one's by "
                             f"{(gi_new.float() - gi_old.float()).abs().max().item()}")
        ok, err = chip_smoke.grad_within(gf_new, gf_old, 1e-5 * gf_old.float().abs().max().item() + 1e-6, fplanes.dtype)
        if not ok:
            raise SystemExit(f"splat backward {key}: the new kernel's grad_flow differs from the old one's by {err}")
        del gi_new, gf_new, gi_old, gf_old
        iters = 5 if planes.numel() > 1e8 else 20
        t = in_turns(old, new, iters)
        turns = [device_ms(fn, iters, "softsplat_backward_kernel") for fn in (old, new, new, old)]
        lib = chip_smoke.device_ms(chip_smoke.splat_backward_library_call(nhwc(planes), nhwc(fplanes), nhwc(gplanes)), iters)
        b = chip_smoke.bound(*chip_smoke.splat_backward_work(planes, fplanes, in_grad))
        t.update({
            "old_device_ms": statistics.mean((turns[0], turns[3])), "new_device_ms": statistics.mean(turns[1:3]),
            "old_device": [turns[0], turns[3]], "new_device": turns[1:3], "library_device_ms": lib,
            "bound_ms": b[0], "bound_by": b[1], "grad_flow_max_abs_diff": err,
        })
        result["by_layout"][key] = t
        print(
            f"splat backward {card}: {key}: op old {t['old_ms']:.4f} ms {t['old']}, new {t['new_ms']:.4f} ms {t['new']}, "
            f"{t['old_ms'] / t['new_ms']:.2f}x; kernel on the device old {t['old_device_ms']:.4f} {t['old_device']}, new "
            f"{t['new_device_ms']:.4f} {t['new_device']}, {t['old_device_ms'] / t['new_device_ms']:.2f}x; two library calls "
            f"{lib:.4f} on the device; bound {b[0]:.4f} ({b[1]}), the new kernel at {100 * b[0] / t['new_device_ms']:.1f} % "
            f"of it, the old at {100 * b[0] / t['old_device_ms']:.1f} %; grad_in bit for bit, grad_flow within {err:.3g}",
            flush=True,
        )
    for path, counts in per_step.items():
        row = {k: sum(n * result["by_layout"][key][k] for key, n in counts.items())
               for k in ("old_device_ms", "new_device_ms", "library_device_ms", "bound_ms")}
        row["launches"] = sum(counts.values())
        result["per_step"][path] = row
        print(
            f"splat backward {card}: one {path} training step's {row['launches']} launches on the device: old "
            f"{row['old_device_ms']:.4f} ms, new {row['new_device_ms']:.4f} ms ({row['old_device_ms'] / row['new_device_ms']:.2f}x), "
            f"two library calls {row['library_device_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms",
            flush=True,
        )
    return result


def m2m_splat_inputs(dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inputs of the one splat of an M2M 1080p bf16 batch-2 forward."""
    captured = {}
    real = m2m.softsplat_func

    def capture(vals, flow):
        captured["vals"], captured["flow"] = vals, flow
        return real(vals, flow)

    fn = m2m.make_model_fn(m2m.init_params(0), dtype=torch.bfloat16, device=dev)
    f0 = torch.from_numpy(np.random.default_rng(0).random((2, 1080, 1920, 3), dtype=np.float32)).to(dev)
    f1 = torch.from_numpy(np.random.default_rng(1).random((2, 1080, 1920, 3), dtype=np.float32)).to(dev)
    m2m.softsplat_func = capture
    try:
        fn(f0, f1, torch.full((2,), 0.5, device=dev))
    finally:
        m2m.softsplat_func = real
    return captured["vals"], captured["flow"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of the checkout to compare with")
    ap.add_argument("--out", default=os.path.join("build", "kernel_compare.json"))
    ap.add_argument("--sections", default=",".join(SECTIONS), help=f"comma-separated, of {', '.join(SECTIONS)}")
    args = ap.parse_args(argv)
    sections = set(args.sections.split(","))
    if not sections <= set(SECTIONS):
        ap.error(f"unknown sections {sorted(sections - set(SECTIONS))}")
    if not torch.cuda.is_available():
        print("kernel_compare: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    result: Dict = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}

    parent_csrc = os.path.join(os.path.abspath(args.parent), "comfyui_frame_interpolation_tpu_torch", "csrc")
    builds = [("warp", build._CSRC), ("softsplat", build._CSRC), ("warp", parent_csrc), ("softsplat", parent_csrc)]
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:  # nvcc runs outside the GIL
        libs = dict(zip(builds, pool.map(lambda b: build.load_library(*b), builds)))
    result["builds"] = {}
    for key in builds:
        which = f"{key[0]} {'parent' if key[1] != build._CSRC else 'this'}"
        result["builds"][which] = build.ptxas_summary(build.build_logs.get(key, ""))
        print(f"build {card}: {which}: " + "; ".join(result["builds"][which]), flush=True)

    if "k1" in sections:
        new_warp = lambda img, flow, zeros: warp(img, flow, "zeros" if zeros else "border")  # noqa: E731
        old_warp_fn = bind(libs["warp", parent_csrc], parent_csrc, "cfi_warp_bilinear")
        result["k1"] = {}
        for name, img, flow, zeros in warp_cases(dev):
            old = call_warp(old_warp_fn, img, flow, zeros)
            new = new_warp(img, flow, zeros)
            torch.cuda.synchronize()
            if not torch.equal(old, new):
                raise SystemExit(f"{name}: new K1 differs from the old one")
            body = warp_kernel.route(img.permute(0, 3, 1, 2).shape, img.permute(0, 3, 1, 2).stride(), img.dtype)
            t = in_turns(lambda: call_warp(old_warp_fn, img, flow, zeros), lambda: new_warp(img, flow, zeros), 20)
            t["new_body"] = body
            result["k1"][name] = t
            print(f"k1 {card}: {name}: old {t['old_ms']:.4f} ms {t['old']}, new ({body}) {t['new_ms']:.4f} ms {t['new']}, "
                  f"{t['old_ms'] / t['new_ms']:.2f}x; bit-exact", flush=True)
            del old, new, img, flow
    if "k2" in sections:
        vals = torch.rand(16, 1088, 1920, 4, generator=torch.Generator().manual_seed(1)).to(dev, torch.bfloat16)
        sflow = torch.from_numpy(smooth_flow(16, 1088, 1920, 8.0)).to(dev)
        mvals, mflow = m2m_splat_inputs(dev)
        splat_cases = [
            ("splat [16,1088,1920,4] bf16 smooth amp 8", vals, sflow),
            (f"splat M2M forward {list(mvals.shape)} bf16 rough flow", mvals, mflow),
        ]
        old_splat_fn = bind(libs["softsplat", parent_csrc], parent_csrc, "cfi_softsplat")
        result["k2"] = {}
        for name, v, f in splat_cases:
            old = call_splat(old_splat_fn, v, f).float()
            new = softsplat_func(v, f).float()
            torch.cuda.synchronize()
            # sums of M2M's weighted values cancel, so the check is relative
            # to the largest output: one bf16 ulp of it
            rel = ((new - old).abs().max() / old.abs().max().clamp_min(1e-30)).item()
            if rel > 2.0**-8:
                raise SystemExit(f"{name}: new K2 differs from the old one by {rel} of the largest output")
            t = in_turns(lambda: call_splat(old_splat_fn, v, f), lambda: softsplat_func(v, f), 10)
            t["max_err_rel_to_max"] = rel
            result["k2"][name] = t
            print(f"k2 {card}: {name}: old {t['old_ms']:.4f} ms {t['old']}, new {t['new_ms']:.4f} ms {t['new']}, "
                  f"{t['old_ms'] / t['new_ms']:.2f}x; max diff {rel:.3g} of the largest output", flush=True)
        del splat_cases, vals, sflow, mvals, mflow
    if "wide" in sections:
        result["wide"] = wide_section(dev, bind(libs["warp", parent_csrc], parent_csrc, "cfi_warp_bilinear_wide"), card)
        torch.cuda.empty_cache()
    if "threshold" in sections:
        # the routing threshold: K1 against the wide kernel, in turns
        result["threshold"] = {}
        g = torch.Generator().manual_seed(3)
        flow = torch.from_numpy(smooth_flow(4, 1088, 1920, 6.0)).to(dev)
        fplanes = flow.permute(0, 3, 1, 2)
        for dtype, channels in THRESHOLD_CHANNELS.items():
            for c in channels:
                img = torch.rand(4, 1088, 1920, c, generator=g).to(dev, dtype)
                planes = img.permute(0, 3, 1, 2)
                t = in_turns(lambda: warp_kernel.warp_bilinear(planes, fplanes), lambda: warp_kernel.warp_bilinear_wide(planes, fplanes), 20)
                key = f"[4,1088,1920,{c}] {str(dtype).split('.')[-1]}"
                result["threshold"][key] = {"tiled_ms": t["old_ms"], "wide_ms": t["new_ms"], "tiled": t["old"], "wide": t["new"]}
                print(f"threshold {card}: {key} ({c * dtype.itemsize} B a pixel): tiled {t['old_ms']:.4f} ms {t['old']}, "
                      f"wide {t['new_ms']:.4f} ms {t['new']}; routed to {warp_kernel.route(planes.shape, planes.stride(), dtype)}",
                      flush=True)

    if "backward" in sections:
        old_backward = bind(libs["warp", parent_csrc], parent_csrc, "cfi_warp_bilinear_backward")
        result["backward"] = backward_section(dev, old_backward, card)
        torch.cuda.empty_cache()

    if "splat_backward" in sections:
        old_splat_backward = bind(libs["softsplat", parent_csrc], parent_csrc, "cfi_softsplat_backward")
        result["splat_backward"] = splat_backward_section(dev, old_splat_backward, card)
        torch.cuda.empty_cache()

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"kernel_compare {card}: done, {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
