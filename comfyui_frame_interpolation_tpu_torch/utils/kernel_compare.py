"""Time this checkout's warp and splat kernels against another checkout's, and
K1's bodies against each other, on one CUDA card.

Run from the repository root on the machine with the card::

    python -m comfyui_frame_interpolation_tpu_torch.utils.kernel_compare \\
        --parent build/parent [--out build/kernel_compare.json]

``--parent`` names the root of another checkout (for instance the parent
commit, unpacked with ``git archive``). Its ``csrc/warp.cu`` and
``csrc/softsplat.cu`` are built beside this checkout's, and each version is
timed in turns (old, new, new, old) in this one process, on the same tensors,
at the main paths' shapes:

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

It also times K1 against the wide kernel at ``[4, 1088, 1920, C]`` bf16, C =
3 to 32, the sweep that placed the routing threshold
(``warp_kernel.WIDE_MIN_BYTES``).

Every line printed names the card and its power limit; the numbers also go to
``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import statistics
import subprocess
import sys
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..models import m2m
from ..ops.cuda import build, warp_kernel
from ..ops.cuda.build import DTYPE_CODES
from ..ops.softsplat import softsplat_func
from ..ops.warp import warp

WARP_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_int64] * 16 + [ctypes.c_void_p]
SPLAT_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_int64] * 16 + [ctypes.c_void_p]
THRESHOLD_CHANNELS = (3, 4, 7, 8, 12, 16, 24, 32)


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


def bind(lib: ctypes.CDLL, name: str, argtypes) -> Callable:
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def call_warp(fn: Callable, img: torch.Tensor, flow: torch.Tensor, zeros: bool) -> torch.Tensor:
    """``fn`` (a ``cfi_warp_bilinear``-like entry) on NHWC ``img``/``flow``."""
    planes, fplanes = img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)
    out = torch.empty_like(planes)
    n, c, h, w = planes.shape
    rc = fn(
        planes.data_ptr(), fplanes.data_ptr(), out.data_ptr(), DTYPE_CODES[img.dtype], DTYPE_CODES[flow.dtype],
        int(zeros), n, c, h, w, *planes.stride(), *fplanes.stride(), *out.stride(),
        torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"warp launch returned {rc}")
    return out.permute(0, 2, 3, 1)


def call_splat(fn: Callable, vals: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The splat op around ``fn`` (a ``cfi_softsplat`` entry): zero fill,
    kernel, cast, as ``ops.softsplat.softsplat_func`` does."""
    planes, fplanes = vals.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)
    out = torch.zeros_like(planes, dtype=torch.float32)
    n, c, h, w = planes.shape
    rc = fn(
        planes.data_ptr(), fplanes.data_ptr(), out.data_ptr(), DTYPE_CODES[vals.dtype], DTYPE_CODES[flow.dtype],
        n, c, h, w, *planes.stride(), *fplanes.stride(), *out.stride(), torch.cuda.current_stream().cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"splat launch returned {rc}")
    return out.permute(0, 2, 3, 1).to(vals.dtype)


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
    args = ap.parse_args(argv)
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

    new_warp = lambda img, flow, zeros: warp(img, flow, "zeros" if zeros else "border")  # noqa: E731
    cases = warp_cases(dev)
    vals = torch.rand(16, 1088, 1920, 4, generator=torch.Generator().manual_seed(1)).to(dev, torch.bfloat16)
    sflow = torch.from_numpy(smooth_flow(16, 1088, 1920, 8.0)).to(dev)
    mvals, mflow = m2m_splat_inputs(dev)
    splat_cases = [
        ("splat [16,1088,1920,4] bf16 smooth amp 8", vals, sflow),
        (f"splat M2M forward {list(mvals.shape)} bf16 rough flow", mvals, mflow),
    ]
    old_warp_fn = bind(libs["warp", parent_csrc], "cfi_warp_bilinear", WARP_ARGS)
    old_splat_fn = bind(libs["softsplat", parent_csrc], "cfi_softsplat", SPLAT_ARGS)
    result["k1"] = {}
    for name, img, flow, zeros in cases:
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
    del cases
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

    # the routing threshold: K1 against the wide kernel
    result["threshold"] = {}
    g = torch.Generator().manual_seed(3)
    flow = torch.from_numpy(smooth_flow(4, 1088, 1920, 6.0)).to(dev)
    for c in THRESHOLD_CHANNELS:
        img = torch.rand(4, 1088, 1920, c, generator=g).to(dev, torch.bfloat16)
        planes, fplanes = img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)
        tiled = ms(lambda: warp_kernel.warp_bilinear(planes, fplanes), 20)
        wide = ms(lambda: warp(img, flow, prefer_wide=True), 20)
        result["threshold"][f"[4,1088,1920,{c}] bf16"] = {"tiled_ms": tiled, "wide_ms": wide}
        print(f"threshold {card}: [4,1088,1920,{c}] bf16 ({2 * c} B a pixel): tiled {tiled:.4f} ms, wide {wide:.4f} ms", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"kernel_compare {card}: done, {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
