#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``comfyui_frame_interpolation_tpu_torch``)
on one NVIDIA GPU: the quickest proof that the port still starts on the card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, one line each; any failed phase raises and the exit code is not 0:

1. device  -- a CUDA device, its name and power limit (``nvidia-smi``);
2. build   -- the warp kernel built from ``csrc/warp.cu`` with ``nvcc``;
3. kernel  -- the kernel against its plain PyTorch twin on the card, on the
   flow cases of ``tests/warp_cases.py`` (border and zeros, f32 and bf16, at
   256x512) and at the main path's shape ``[16, 1088, 1920, 7]`` bf16.
   Tolerances: f32 atol 2e-6 on values in [0, 1], bf16 one ulp (2**-8);
4. node    -- the RIFE VFI node (``rife47.pth``, fast mode, no ensemble,
   random weights from seed 0) on 4 frames of 540x960, multiplier 2, batch 2,
   on the card in fp32 (TF32 off) and bf16, each >= 40 dB PSNR against the
   same node on the CPU (plain twin) in fp32; the warp kernel must have been
   launched exactly 4 times per forward call;
5. golden  -- the port on the card (fp32, TF32 off) against the JAX RIFE 4.7
   output stored in ``tests/fixtures/torch_port_rife47_golden.npz``, >= 40 dB;
6. timing  -- RIFE 4.7 1080p 2x bf16 batch 8 (the configuration of
   ``bench.py:bench_rife``) in frames/s, and the warp kernel's ms per call at
   ``[16, 1088, 1920, 7]`` bf16 beside the plain twin's.

Then the kernel table as one JSON line, and as the last line
``{"ok": true, "device": {...}}``. Nothing of JAX is imported.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
F32_ATOL = 2e-6
BF16_ATOL = 2.0**-8
MAIN_SHAPE = (16, 1088, 1920, 7)  # a batch-8 1080p RIFE warp: 2B images, 3+4 channels


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def psnr(a, b):
    mse = ((a.double().cpu() - b.double().cpu()) ** 2).mean().item()
    return math.inf if mse == 0 else 10 * math.log10(1.0 / mse)


def cuda_ms(fn, iters):
    """Mean ms per call of ``fn()`` between CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def shifted_pattern(n, h, w, seed, step=(6.0, 3.0)):
    """``n`` frames of a smooth random pattern, each shifted by ``step`` pixels
    from the last, so the flows between them are non-trivial."""
    import numpy as np

    rng = np.random.default_rng(seed)
    freq = rng.uniform(0.01, 0.05, (3, 2, 2))
    phase = rng.uniform(0, 2 * np.pi, (3, 2))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = np.empty((n, h, w, 3), np.float32)
    for k in range(n):
        x, y = xx - k * step[0], yy - k * step[1]
        for c in range(3):
            frames[k, ..., c] = 0.5 + 0.25 * np.sin(freq[c, 0, 0] * x + freq[c, 0, 1] * y + phase[c, 0]) + 0.2 * np.cos(
                freq[c, 1, 0] * x - freq[c, 1, 1] * y + phase[c, 1]
            )
    return frames


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import warp_cases
    from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_timestep
    from comfyui_frame_interpolation_tpu_torch.models import rife
    from comfyui_frame_interpolation_tpu_torch.nodes.rife_node import RIFE_VFI
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import build, warp_kernel
    from comfyui_frame_interpolation_tpu_torch.ops.warp import warp, warp_torch
    from comfyui_frame_interpolation_tpu_torch.utils.benchmark import measure

    dev = torch.device("cuda")

    # ---- 1. device -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s), torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library("warp")
    print(f"build {card}: csrc/warp.cu built with nvcc and loaded in {time.perf_counter() - t0:.2f} s", flush=True)

    # ---- 3. kernel vs plain on the card --------------------------------------
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_cases = 0
    for case in warp_cases.warp_cases(0, 256, 512):
        for mode in case["modes"]:
            for dtype, atol in ((torch.float32, F32_ATOL), (torch.bfloat16, BF16_ATOL)):
                img = torch.from_numpy(case["img"]).to(dev, dtype)
                flow = torch.from_numpy(case["flow"]).to(dev)
                got, ref = warp(img, flow, mode), warp_torch(img, flow, mode)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                check(err <= atol, f"kernel vs plain: {case['name']} {mode} {dtype}: max err {err} > {atol}")
                worst[dtype] = max(worst[dtype], err)
                n_cases += 1
    g = torch.Generator().manual_seed(0)
    main_img = torch.rand(MAIN_SHAPE, generator=g).to(dev, torch.bfloat16)
    main_flow = torch.from_numpy(warp_cases.smooth_flow(*MAIN_SHAPE[:3], amp=6.0)).to(dev)
    got, ref = warp(main_img, main_flow), warp_torch(main_img, main_flow)
    torch.cuda.synchronize()
    main_err = (got.float() - ref.float()).abs().max().item()
    check(main_err <= BF16_ATOL, f"kernel vs plain at {MAIN_SHAPE}: max err {main_err} > {BF16_ATOL}")
    del got, ref
    print(
        f"kernel vs plain: {n_cases} cases at 256x512 max err f32 {worst[torch.float32]} (tol {F32_ATOL}), "
        f"bf16 {worst[torch.bfloat16]} (tol {BF16_ATOL}); {list(MAIN_SHAPE)} bf16 max err {main_err}",
        flush=True,
    )

    # ---- 4. RIFE node end to end ---------------------------------------------
    params = rife.init_params(0, "4.7")
    frames = shifted_pattern(4, 540, 960, seed=0)
    multiplier, batch = 2, 2
    kw = dict(multiplier=multiplier, fast_mode=True, ensemble=False, batch_size=batch, params=params)
    node = RIFE_VFI()
    calls_per_run = math.ceil(len(plan_timestep(4, multiplier).tasks) / batch)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    warp_kernel.launches = 0
    (out_f32,) = node.vfi("rife47.pth", frames, dtype="float32", device="cuda", **kw)
    (out_bf16,) = node.vfi("rife47.pth", frames, dtype="bfloat16", device="cuda", **kw)
    torch.cuda.synchronize()
    main_path_launches = warp_kernel.launches
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    (out_cpu,) = node.vfi("rife47.pth", frames, dtype="float32", device="cpu", **kw)
    n_out = 2 * 4 - 1
    for out in (out_f32, out_bf16):
        check(tuple(out.shape) == (n_out, 540, 960, 3) and out.is_cuda, f"node output {tuple(out.shape)} on {out.device}")
        check(bool(torch.isfinite(out).all()), "node output has non-finite values")
    check(torch.equal(out_f32[::2].cpu(), torch.from_numpy(frames)), "original frames not passed through")
    p32, p16 = psnr(out_f32, out_cpu), psnr(out_bf16, out_cpu)
    check(p32 >= 40.0, f"node fp32 cuda vs cpu {p32:.2f} dB < 40")
    check(p16 >= 40.0, f"node bf16 cuda vs fp32 cpu {p16:.2f} dB < 40")
    check(
        main_path_launches == 4 * 2 * calls_per_run,
        f"warp launches {main_path_launches} != 4 x {2 * calls_per_run} forward calls",
    )
    print(
        f"node: RIFE 4.7 4x540x960 x2 batch {batch} -> {n_out} frames; cuda fp32 vs cpu {p32:.2f} dB, "
        f"cuda bf16 vs cpu fp32 {p16:.2f} dB; warp launches {main_path_launches} = 4 x {2 * calls_per_run} forward calls",
        flush=True,
    )

    # ---- 5. JAX golden -------------------------------------------------------
    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_port_rife47_golden.npz")) as z:
        seed, golden = int(z["seed"]), torch.from_numpy(z["output"])
    gframes = torch.from_numpy(np.random.default_rng(seed).random((2, 1, 64, 128, 3), dtype=np.float32)).to(dev)
    net = rife.IFNet("4.7")
    net.load_state_dict(rife.init_params(seed, "4.7"), strict=True)
    net = net.to(dev, memory_format=torch.channels_last).eval()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        gout = rife.apply(net, gframes[0], gframes[1], torch.full((1,), 0.5, device=dev), rife.default_scale_list("4.7"))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    pg = psnr(gout, golden)
    check(pg >= 40.0, f"golden: {pg:.2f} dB < 40")
    print(f"golden: port on cuda fp32 vs JAX RIFE 4.7 fp32 {pg:.2f} dB, max abs err {(gout.cpu() - golden).abs().max().item():.3g}", flush=True)

    # ---- 6. timing -----------------------------------------------------------
    model_fn = rife.make_model_fn(params, "4.7", fastmode=True, ensemble=False, dtype=torch.bfloat16, device=dev)
    f0 = torch.from_numpy(np.random.default_rng(0).random((8, 1080, 1920, 3), dtype=np.float32)).to(dev)
    f1 = torch.from_numpy(np.random.default_rng(1).random((8, 1080, 1920, 3), dtype=np.float32)).to(dev)
    t = torch.full((8,), 0.5, device=dev)
    fps = 8 / measure(model_fn, f0, f1, t, iters=10, rounds=3)
    del f0, f1
    # plain, kernel, kernel, plain: the two versions are compared in turns
    plain_a = cuda_ms(lambda: warp_torch(main_img, main_flow), 5)
    kern_a = cuda_ms(lambda: warp(main_img, main_flow), 50)
    kern_b = cuda_ms(lambda: warp(main_img, main_flow), 50)
    plain_b = cuda_ms(lambda: warp_torch(main_img, main_flow), 5)
    kernel_ms, plain_ms = statistics.mean((kern_a, kern_b)), statistics.mean((plain_a, plain_b))
    print(
        f"timing {card}: RIFE 4.7 1080p 2x bf16 batch 8 {fps:.2f} frames/s; warp {list(MAIN_SHAPE)} bf16 "
        f"kernel {kernel_ms:.4f} ms ({kern_a:.4f}, {kern_b:.4f}), plain {plain_ms:.4f} ms ({plain_a:.4f}, {plain_b:.4f})",
        flush=True,
    )

    print(json.dumps({"kernels": [{
        "name": "warp_bilinear",
        "route": "cuda",
        "source": "comfyui_frame_interpolation_tpu_torch/csrc/warp.cu",
        "replaces": "comfyui_frame_interpolation_tpu/ops/pallas/warp_kernel.py:78",
        "launches": main_path_launches,
        "max_abs_err": main_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
