#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``comfyui_frame_interpolation_tpu_torch``)
on one NVIDIA GPU: the quickest proof that the port still starts on the card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, one line each; any failed phase raises and the exit code is not 0:

1. device  -- a CUDA device, its name and power limit (``nvidia-smi``);
2. build   -- the warp and splat kernels built from ``csrc/warp.cu`` and
   ``csrc/softsplat.cu``, one ``nvcc`` each, started together;
3. kernel  -- the warp kernel against its plain PyTorch twin on the card, on
   the flow cases of ``tests/warp_cases.py`` (border and zeros, f32 and bf16,
   at 256x512) and at the RIFE path's shape ``[16, 1088, 1920, 7]`` bf16.
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
   ``[16, 1088, 1920, 7]`` bf16 beside the plain twin's;
7. splat   -- the splat kernel against its plain twin on the card, on the
   splat cases of ``tests/warp_cases.py`` (256x512 and the narrow frames, f32
   and bf16) and at the M2M path's shape ``[16, 1088, 1920, 4]`` bf16.
   Tolerances: f32 atol 1e-5 on values in [0, 1] (fp32 atomics sum in an
   order that changes from run to run), bf16 one ulp of the output (2**-8 to
   2**-7 of the value);
8. m2m     -- the M2M VFI node (``M2M.pth``, random weights from seed 0) on 4
   frames of 540x960, multipliers 2 and 3, batch 2, on the card in fp32 (TF32
   off) and bf16, each >= 40 dB against the same node on the CPU in fp32;
   original frames pass through bit for bit; exactly 1 splat launch per infer
   call and 20 warp launches per reuse call;
9. golden  -- the port's M2M on the card (fp32, TF32 off) against the JAX M2M
   output stored in ``tests/fixtures/torch_port_m2m_golden.npz``, >= 40 dB;
10. timing -- M2M 1080p 2x bf16 batch 2 (the configuration of
   ``bench.py:bench_m2m``) in frames/s through ``make_model_fn``, reuse and
   infer ms through ``make_pair_fns``, the splat kernel's ms per call at
   ``[16, 1088, 1920, 4]`` bf16 beside the plain twin's, and a
   ``torch.profiler`` top 10 of one M2M forward with the kernels' share of
   device time.

11. wide     -- the wide-channel warp kernel against the plain twin on the
   card, bit for bit (max abs err 0), on the wide cases of
   ``tests/warp_cases.py`` (C = 32, 64, 192, 448, 960, 46; a channel slice
   whose taps start off 16 bytes; extreme and non-finite flow; border and
   zeros, f32 and bf16, at 128x256) and at FILM's level-0 feature warp
   ``[4, 1080, 1920, 64]`` bf16, where the per-pixel kernel must agree too;
12. film     -- the FILM VFI node (``film_net_fp32.pt``, random weights from
   seed 0) on 4 frames of 270x480 (at 540x960 the CPU leg's 7 batch-2 fp32
   calls take about 2 minutes on 8 cores), multipliers 2 and 4, batch 2, on the card
   in fp32 (TF32 off) and bf16, each >= 40 dB against the same node on the
   CPU in fp32; original frames pass through bit for bit; exactly 11 wide and
   5 per-pixel warp launches per forward call (``film.WARPS_PER_CALL``);
13. golden   -- the port's FILM on the card (fp32, TF32 off) against the JAX
   FILM output stored in ``tests/fixtures/torch_port_film_golden.npz``,
   >= 40 dB;
14. timing   -- FILM 1080p 2x bf16 batch 2 (the configuration of
   ``bench.py:bench_film``) in frames/s, each stage's ms, the wide kernel's,
   the per-pixel kernel's and the plain twin's ms per call on the same
   tensors at ``[4, 1080, 1920, 64]`` and ``[4, 135, 240, 960]`` bf16, and a
   ``torch.profiler`` top 10 of one FILM forward with both warp kernels'
   shares of device time and the idle share.

Each main path (phases 4, 8 and 12) is driven with the launch counts set to
0 just before it and read just after. Then the kernel table as one JSON line,
and as the last line ``{"ok": true, "device": {...}}``. Nothing of JAX is
imported.
"""

import concurrent.futures
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
SPLAT_F32_ATOL = 1e-5
SPLAT_SHAPE = (16, 1088, 1920, 4)  # a batch-2 1080p M2M splat: 2 directions x 2 pairs x 4 branches, 3+1 channels
M2M_HW = (540, 960)
FILM_HW = (270, 480)
FILM_WARP_SHAPES = ((4, 1080, 1920, 64), (4, 135, 240, 960))  # FILM 1080p batch 2: level-0 and level-3 feature warps
WIDE_CHANNELS = (32, 64, 192, 448, 960)


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


def bf16_ulp_ok(got, ref):
    """Every element of ``got`` within one bf16 ulp of ``ref``'s value."""
    import torch

    _, exp = torch.frexp(ref.float().abs())
    ulp = torch.ldexp(torch.ones_like(ref, dtype=torch.float32), exp - 8)
    return bool(((got.float() - ref.float()).abs() <= ulp).all())


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


def profile_forward(what, model_fn, f0, f1, t, card, kernels):
    """``torch.profiler`` over one forward of ``model_fn`` after warm-up: the
    top 10 ops by device time, the share of the device time that each kernel
    of ``kernels`` (label -> substring of its name) takes, and the device's
    idle share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def device_us(evt):
        return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)

    model_fn(f0, f1, t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model_fn(f0, f1, t)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    on_device = [e for e in events if str(getattr(e, "device_type", "")).endswith("CUDA")]
    device_total = sum(device_us(e) for e in on_device)
    check(device_total > 0, "profiler saw no device time")
    shares = ", ".join(
        f"{label} {100 * sum(device_us(e) for e in on_device if name in e.key) / device_total:.2f} %"
        for label, name in kernels.items()
    )
    n_kernels = sum(e.count for e in on_device)
    ops = sorted((e for e in events if e not in on_device and device_us(e) > 0), key=device_us, reverse=True)
    print(
        f"profile {card}: one {what} forward, {device_total / 1e3:.3f} ms of kernels in "
        f"{wall_us / 1e3:.3f} ms wall, idle share {max(0.0, 1 - device_total / wall_us):.4f}, {n_kernels} kernels; "
        f"{shares} of device time",
        flush=True,
    )
    for e in ops[:10]:
        print(f"  profile op {e.key}: {device_us(e) / 1e3:.3f} ms ({100 * device_us(e) / device_total:.2f} %), {e.count} calls")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import warp_cases
    from comfyui_frame_interpolation_tpu_torch.core.loop import _pair_groups
    from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_bisection, plan_timestep
    from comfyui_frame_interpolation_tpu_torch.models import film, m2m, rife
    from comfyui_frame_interpolation_tpu_torch.nodes.rife_node import RIFE_VFI
    from comfyui_frame_interpolation_tpu_torch.nodes.vfi_nodes import FILM_VFI, M2M_VFI
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import build, softsplat_kernel, warp_kernel
    from comfyui_frame_interpolation_tpu_torch.ops.softsplat import softsplat_func, softsplat_torch
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
    def timed_build(name):
        t0 = time.perf_counter()
        build.load_library(name)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:  # nvcc runs outside the GIL
        build_s = dict(zip(("warp", "softsplat"), pool.map(timed_build, ("warp", "softsplat"))))
    print(
        f"build {card}: csrc/warp.cu {build_s['warp']:.2f} s, csrc/softsplat.cu {build_s['softsplat']:.2f} s "
        f"(nvcc, in parallel: {time.perf_counter() - t0:.2f} s in all), both loaded",
        flush=True,
    )

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
    rife_warp_launches = warp_kernel.launches
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
        rife_warp_launches == 4 * 2 * calls_per_run,
        f"warp launches {rife_warp_launches} != 4 x {2 * calls_per_run} forward calls",
    )
    print(
        f"node: RIFE 4.7 4x540x960 x2 batch {batch} -> {n_out} frames; cuda fp32 vs cpu {p32:.2f} dB, "
        f"cuda bf16 vs cpu fp32 {p16:.2f} dB; warp launches {rife_warp_launches} = 4 x {2 * calls_per_run} forward calls",
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

    del main_img, main_flow

    # ---- 7. splat kernel vs plain on the card --------------------------------
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n_cases = 0
    for case in warp_cases.splat_cases(0, 256, 512):
        for dtype in (torch.float32, torch.bfloat16):
            vals = torch.from_numpy(case["vals"]).to(dev, dtype)
            flow = torch.from_numpy(case["flow"]).to(dev)
            got, ref = softsplat_func(vals, flow), softsplat_torch(vals, flow)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs().max().item()
            ok = err <= SPLAT_F32_ATOL if dtype == torch.float32 else bf16_ulp_ok(got, ref)
            check(ok and got.dtype == dtype, f"splat kernel vs plain: {case['name']} {dtype}: max err {err}")
            worst[dtype] = max(worst[dtype], err)
            n_cases += 1
    splat_vals = torch.rand(SPLAT_SHAPE, generator=g).to(dev, torch.bfloat16)
    splat_flow = torch.from_numpy(warp_cases.smooth_flow(*SPLAT_SHAPE[:3], amp=8.0)).to(dev)
    got, ref = softsplat_func(splat_vals, splat_flow), softsplat_torch(splat_vals, splat_flow)
    torch.cuda.synchronize()
    splat_err = (got.float() - ref.float()).abs().max().item()
    check(bf16_ulp_ok(got, ref), f"splat kernel vs plain at {SPLAT_SHAPE}: max err {splat_err} beyond one bf16 ulp")
    del got, ref
    print(
        f"splat kernel vs plain: {n_cases} cases at 256x512 and narrow frames, max err f32 {worst[torch.float32]} "
        f"(tol {SPLAT_F32_ATOL}), bf16 {worst[torch.bfloat16]} (tol one ulp); {list(SPLAT_SHAPE)} bf16 max err "
        f"{splat_err} (within one ulp)",
        flush=True,
    )

    # ---- 8. M2M node end to end ----------------------------------------------
    m2m_params = m2m.init_params(0)
    frames = shifted_pattern(4, *M2M_HW, seed=1)
    node = M2M_VFI()
    batch = 2
    expect_reuse = expect_infer = 0
    for multiplier in (2, 3):
        _, by_count = _pair_groups(plan_timestep(4, multiplier))
        expect_reuse += sum(math.ceil(len(keys) / batch) for keys in by_count.values())
        expect_infer += sum(m_ * math.ceil(len(keys) / batch) for m_, keys in by_count.items())
    expect_reuse, expect_infer = 2 * expect_reuse, 2 * expect_infer  # fp32 and bf16
    outs = {}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    warp_kernel.launches = softsplat_kernel.launches = 0
    for multiplier in (2, 3):
        for dtype in ("float32", "bfloat16"):
            (outs[multiplier, dtype],) = node.vfi(
                "M2M.pth", frames, multiplier=multiplier, batch_size=batch, dtype=dtype, params=m2m_params, device="cuda"
            )
    torch.cuda.synchronize()
    m2m_warp_launches, m2m_splat_launches = warp_kernel.launches, softsplat_kernel.launches
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    check(
        m2m_splat_launches == expect_infer,
        f"splat launches {m2m_splat_launches} != 1 x {expect_infer} infer calls",
    )
    check(
        m2m_warp_launches == m2m.WARPS_PER_REUSE * expect_reuse,
        f"warp launches {m2m_warp_launches} != {m2m.WARPS_PER_REUSE} x {expect_reuse} reuse calls",
    )
    m2m_psnr = []
    t0 = time.perf_counter()
    for multiplier in (2, 3):
        (out_cpu,) = node.vfi(
            "M2M.pth", frames, multiplier=multiplier, batch_size=batch, dtype="float32", params=m2m_params, device="cpu"
        )
        n_out = 3 * multiplier + 1
        for dtype in ("float32", "bfloat16"):
            out = outs[multiplier, dtype]
            check(tuple(out.shape) == (n_out, *M2M_HW, 3) and out.is_cuda, f"M2M node output {tuple(out.shape)} on {out.device}")
            check(bool(torch.isfinite(out).all()), f"M2M node x{multiplier} {dtype} has non-finite values")
            check(
                torch.equal(out[::multiplier].cpu(), torch.from_numpy(frames)),
                f"M2M x{multiplier} {dtype}: original frames not passed through",
            )
            p = psnr(out, out_cpu)
            check(p >= 40.0, f"M2M node x{multiplier} cuda {dtype} vs cpu fp32 {p:.2f} dB < 40")
            m2m_psnr.append(f"x{multiplier} {dtype} {p:.2f} dB")
    cpu_s = time.perf_counter() - t0
    print(
        f"m2m: M2M node 4x{M2M_HW[0]}x{M2M_HW[1]} x2 and x3 batch {batch}, cuda vs cpu fp32: {', '.join(m2m_psnr)} "
        f"(cpu leg {cpu_s:.1f} s); splat launches {m2m_splat_launches} = 1 x {expect_infer} infer calls, "
        f"warp launches {m2m_warp_launches} = {m2m.WARPS_PER_REUSE} x {expect_reuse} reuse calls",
        flush=True,
    )
    del outs, out_cpu

    # ---- 9. M2M JAX golden ---------------------------------------------------
    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_port_m2m_golden.npz")) as z:
        seed, gt, golden = int(z["seed"]), torch.from_numpy(z["t"]), torch.from_numpy(z["output"])
    rng = np.random.default_rng(seed)
    g0 = torch.from_numpy(rng.random(tuple(golden.shape), dtype=np.float32))
    g1 = torch.from_numpy(rng.random(tuple(golden.shape), dtype=np.float32))
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    gout = m2m.make_model_fn(m2m.init_params(seed), device=dev)(g0, g1, gt)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    pg = psnr(gout, golden)
    check(pg >= 40.0, f"M2M golden: {pg:.2f} dB < 40")
    print(f"golden: port M2M on cuda fp32 vs JAX M2M fp32 {pg:.2f} dB, max abs err {(gout.cpu() - golden).abs().max().item():.3g}", flush=True)

    # ---- 10. M2M timing ------------------------------------------------------
    model_fn = m2m.make_model_fn(m2m_params, dtype=torch.bfloat16, device=dev)
    f0 = torch.from_numpy(np.random.default_rng(0).random((2, 1080, 1920, 3), dtype=np.float32)).to(dev)
    f1 = torch.from_numpy(np.random.default_rng(1).random((2, 1080, 1920, 3), dtype=np.float32)).to(dev)
    t = torch.full((2,), 0.5, device=dev)
    m2m_fps = 2 / measure(model_fn, f0, f1, t, iters=5, rounds=3)
    reuse_fn, infer_fn = m2m.make_pair_fns(m2m_params, dtype=torch.bfloat16, device=dev)
    cache = reuse_fn(f0, f1)
    reuse_ms = cuda_ms(lambda: reuse_fn(f0, f1), 5)
    infer_ms = cuda_ms(lambda: infer_fn(f0, f1, cache, t), 10)
    del cache
    # plain, kernel, kernel, plain: the two versions are compared in turns
    splat_plain_a = cuda_ms(lambda: softsplat_torch(splat_vals, splat_flow), 3)
    splat_kern_a = cuda_ms(lambda: softsplat_func(splat_vals, splat_flow), 20)
    splat_kern_b = cuda_ms(lambda: softsplat_func(splat_vals, splat_flow), 20)
    splat_plain_b = cuda_ms(lambda: softsplat_torch(splat_vals, splat_flow), 3)
    splat_ms = statistics.mean((splat_kern_a, splat_kern_b))
    splat_plain_ms = statistics.mean((splat_plain_a, splat_plain_b))
    del splat_vals, splat_flow
    print(
        f"timing {card}: M2M 1080p 2x bf16 batch 2 {m2m_fps:.3f} frames/s; reuse {reuse_ms:.3f} ms, infer "
        f"{infer_ms:.3f} ms per pair batch; splat {list(SPLAT_SHAPE)} bf16 kernel {splat_ms:.4f} ms "
        f"({splat_kern_a:.4f}, {splat_kern_b:.4f}), plain {splat_plain_ms:.4f} ms ({splat_plain_a:.4f}, {splat_plain_b:.4f})",
        flush=True,
    )
    profile_forward(
        "M2M 1080p bf16 b2", model_fn, f0, f1, t, card,
        {"splat kernel": "softsplat_kernel", "warp kernel": "warp_bilinear_kernel"},
    )
    del f0, f1

    # ---- 11. wide warp kernel vs plain on the card ---------------------------
    n_cases = 0
    for case in warp_cases.wide_cases(0, 128, 256, channels=WIDE_CHANNELS):
        for mode in case["modes"]:
            for dtype in (torch.float32, torch.bfloat16):
                img = torch.from_numpy(case["img"]).to(dev, dtype)[..., case["offset"] :]
                flow = torch.from_numpy(case["flow"]).to(dev)
                got, ref = warp(img, flow, mode, prefer_wide=True), warp_torch(img, flow, mode)
                torch.cuda.synchronize()
                err = (got.float() - ref.float()).abs().max().item()
                check(torch.equal(got, ref), f"wide kernel vs plain: {case['name']} {mode} {dtype}: max err {err}, not bit-exact")
                n_cases += 1
    wide_img = torch.rand(FILM_WARP_SHAPES[0], generator=g).to(dev, torch.bfloat16)
    wide_flow = torch.from_numpy(warp_cases.smooth_flow(*FILM_WARP_SHAPES[0][:3], amp=6.0)).to(dev)
    got, ref = warp(wide_img, wide_flow, prefer_wide=True), warp_torch(wide_img, wide_flow)
    k1 = warp(wide_img, wide_flow)
    torch.cuda.synchronize()
    wide_err = (got.float() - ref.float()).abs().max().item()
    k1_err = (k1.float() - ref.float()).abs().max().item()
    check(torch.equal(got, ref), f"wide kernel vs plain at {FILM_WARP_SHAPES[0]}: max err {wide_err}, not bit-exact")
    check(torch.equal(k1, ref), f"per-pixel kernel vs plain at {FILM_WARP_SHAPES[0]}: max err {k1_err}, not bit-exact")
    del got, ref, k1
    print(
        f"wide kernel vs plain: {n_cases} cases at 128x256 (C {', '.join(map(str, WIDE_CHANNELS))}, 46, unaligned, "
        f"extreme, non-finite) bit-exact (max err 0); {list(FILM_WARP_SHAPES[0])} bf16 max err wide {wide_err}, "
        f"per-pixel {k1_err}",
        flush=True,
    )

    # ---- 12. FILM node end to end --------------------------------------------
    film_params = film.init_params(0)
    frames = shifted_pattern(4, *FILM_HW, seed=2)
    node = FILM_VFI()
    batch = 2
    film_calls = 2 * sum(
        math.ceil(len(level) / batch) for m_ in (2, 4) for level in plan_bisection(4, m_).levels
    )  # fp32 and bf16
    outs = {}
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    warp_kernel.launches = warp_kernel.wide_launches = 0
    for multiplier in (2, 4):
        for dtype in ("float32", "bfloat16"):
            (outs[multiplier, dtype],) = node.vfi(
                "film_net_fp32.pt", frames, multiplier=multiplier, batch_size=batch, dtype=dtype,
                params=film_params, device="cuda",
            )
    torch.cuda.synchronize()
    film_wide_launches, film_warp_launches = warp_kernel.wide_launches, warp_kernel.launches
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    check(
        film_wide_launches == film.WARPS_PER_CALL["wide"] * film_calls,
        f"wide warp launches {film_wide_launches} != {film.WARPS_PER_CALL['wide']} x {film_calls} forward calls",
    )
    check(
        film_warp_launches == film.WARPS_PER_CALL["narrow"] * film_calls,
        f"per-pixel warp launches {film_warp_launches} != {film.WARPS_PER_CALL['narrow']} x {film_calls} forward calls",
    )
    film_psnr = []
    t0 = time.perf_counter()
    for multiplier in (2, 4):
        (out_cpu,) = node.vfi(
            "film_net_fp32.pt", frames, multiplier=multiplier, batch_size=batch, dtype="float32",
            params=film_params, device="cpu",
        )
        n_out = 3 * multiplier + 1
        for dtype in ("float32", "bfloat16"):
            out = outs[multiplier, dtype]
            check(tuple(out.shape) == (n_out, *FILM_HW, 3) and out.is_cuda, f"FILM node output {tuple(out.shape)} on {out.device}")
            check(bool(torch.isfinite(out).all()), f"FILM node x{multiplier} {dtype} has non-finite values")
            check(
                torch.equal(out[::multiplier].cpu(), torch.from_numpy(frames)),
                f"FILM x{multiplier} {dtype}: original frames not passed through",
            )
            p = psnr(out, out_cpu)
            check(p >= 40.0, f"FILM node x{multiplier} cuda {dtype} vs cpu fp32 {p:.2f} dB < 40")
            film_psnr.append(f"x{multiplier} {dtype} {p:.2f} dB")
    cpu_s = time.perf_counter() - t0
    print(
        f"film: FILM node 4x{FILM_HW[0]}x{FILM_HW[1]} x2 and x4 batch {batch}, cuda vs cpu fp32: {', '.join(film_psnr)} "
        f"(cpu leg {cpu_s:.1f} s); wide warp launches {film_wide_launches} = {film.WARPS_PER_CALL['wide']} x "
        f"{film_calls} forward calls, per-pixel warp launches {film_warp_launches} = "
        f"{film.WARPS_PER_CALL['narrow']} x {film_calls}",
        flush=True,
    )
    del outs, out_cpu

    # ---- 13. FILM JAX golden -------------------------------------------------
    with np.load(os.path.join(ROOT, "tests", "fixtures", "torch_port_film_golden.npz")) as z:
        seed, golden = int(z["seed"]), torch.from_numpy(z["output"])
    rng = np.random.default_rng(seed)
    g0 = torch.from_numpy(rng.random(tuple(golden.shape), dtype=np.float32)).to(dev)
    g1 = torch.from_numpy(rng.random(tuple(golden.shape), dtype=np.float32)).to(dev)
    net = film._load(film.init_params(seed), torch.float32, dev)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        gout = film.apply(net, g0, g1)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    pg = psnr(gout, golden)
    check(pg >= 40.0, f"FILM golden: {pg:.2f} dB < 40")
    print(f"golden: port FILM on cuda fp32 vs JAX FILM fp32 {pg:.2f} dB, max abs err {(gout.cpu() - golden).abs().max().item():.3g}", flush=True)
    del net

    # ---- 14. FILM timing -----------------------------------------------------
    model_fn = film.make_model_fn(film_params, dtype=torch.bfloat16, device=dev)
    f0 = torch.from_numpy(np.random.default_rng(0).random((2, 1080, 1920, 3), dtype=np.float32)).to(dev)
    f1 = torch.from_numpy(np.random.default_rng(1).random((2, 1080, 1920, 3), dtype=np.float32)).to(dev)
    t = torch.full((2,), 0.5, device=dev)
    film_fps = 2 / measure(model_fn, f0, f1, t, iters=5, rounds=3)
    net = film._load(film_params, torch.bfloat16, dev)
    with torch.inference_mode():
        x0, x1 = f0.to(torch.bfloat16), f1.to(torch.bfloat16)
        pyr = film.stage_pyramid(x0, x1)
        feat = film.stage_features(net, pyr)
        fwd, bwd = film.stage_flow(net, feat, 2)
        aligned = film.stage_warp(pyr, feat, fwd, bwd, 2)
        stage_ms = {
            "pyramid": cuda_ms(lambda: film.stage_pyramid(x0, x1), 5),
            "features": cuda_ms(lambda: film.stage_features(net, pyr), 3),
            "flow": cuda_ms(lambda: film.stage_flow(net, feat, 2), 3),
            "warp": cuda_ms(lambda: film.stage_warp(pyr, feat, fwd, bwd, 2), 3),
            "fuse": cuda_ms(lambda: film.stage_fuse(net, aligned), 3),
        }
    del pyr, feat, fwd, bwd, aligned, net
    print(
        f"timing {card}: FILM 1080p 2x bf16 batch 2 {film_fps:.3f} frames/s; stages "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in stage_ms.items()),
        flush=True,
    )
    wide_times = {}
    for shape in FILM_WARP_SHAPES:
        if shape != FILM_WARP_SHAPES[0]:
            wide_img = torch.rand(shape, generator=g).to(dev, torch.bfloat16)
            wide_flow = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=6.0)).to(dev)
        # plain, wide, per-pixel, per-pixel, wide, plain: the versions in turns
        plain_a = cuda_ms(lambda: warp_torch(wide_img, wide_flow), 3)
        wide_a = cuda_ms(lambda: warp(wide_img, wide_flow, prefer_wide=True), 30)
        k1_a = cuda_ms(lambda: warp(wide_img, wide_flow), 10)
        k1_b = cuda_ms(lambda: warp(wide_img, wide_flow), 10)
        wide_b = cuda_ms(lambda: warp(wide_img, wide_flow, prefer_wide=True), 30)
        plain_b = cuda_ms(lambda: warp_torch(wide_img, wide_flow), 3)
        key = "x".join(map(str, shape))
        wide_times[key] = {
            "ms": statistics.mean((wide_a, wide_b)),
            "k1_ms": statistics.mean((k1_a, k1_b)),
            "plain_ms": statistics.mean((plain_a, plain_b)),
        }
        print(
            f"timing {card}: warp {list(shape)} bf16 wide kernel {wide_times[key]['ms']:.4f} ms ({wide_a:.4f}, {wide_b:.4f}), "
            f"per-pixel kernel {wide_times[key]['k1_ms']:.4f} ms ({k1_a:.4f}, {k1_b:.4f}), "
            f"plain {wide_times[key]['plain_ms']:.4f} ms ({plain_a:.4f}, {plain_b:.4f})",
            flush=True,
        )
    del wide_img, wide_flow
    profile_forward(
        "FILM 1080p bf16 b2", model_fn, f0, f1, t, card,
        {"wide warp kernel": "warp_bilinear_wide_kernel", "per-pixel warp kernel": "warp_bilinear_kernel"},
    )
    del f0, f1
    wide_main = wide_times["x".join(map(str, FILM_WARP_SHAPES[0]))]

    print(json.dumps({"kernels": [
        {
            "name": "warp_bilinear",
            "route": "cuda",
            "source": "comfyui_frame_interpolation_tpu_torch/csrc/warp.cu",
            "replaces": "comfyui_frame_interpolation_tpu/ops/pallas/warp_kernel.py:78",
            "launches": rife_warp_launches + m2m_warp_launches + film_warp_launches,
            "launches_by_path": {"rife": rife_warp_launches, "m2m": m2m_warp_launches, "film": film_warp_launches},
            "max_abs_err": main_err,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
        },
        {
            "name": "warp_bilinear_wide",
            "route": "cuda",
            "source": "comfyui_frame_interpolation_tpu_torch/csrc/warp.cu",
            "replaces": "comfyui_frame_interpolation_tpu/ops/pallas/warp_kernel.py:297",
            "launches": film_wide_launches,
            "launches_by_path": {"film": film_wide_launches},
            "max_abs_err": wide_err,
            "ms": wide_main["ms"],
            "plain_ms": wide_main["plain_ms"],
            "per_pixel_kernel_ms": wide_main["k1_ms"],
            "by_shape": wide_times,
        },
        {
            "name": "softsplat",
            "route": "cuda",
            "source": "comfyui_frame_interpolation_tpu_torch/csrc/softsplat.cu",
            "replaces": "comfyui_frame_interpolation_tpu/ops/pallas/softsplat_kernel.py:365",
            "launches": m2m_splat_launches,
            "launches_by_path": {"m2m": m2m_splat_launches},
            "max_abs_err": splat_err,
            "ms": splat_ms,
            "plain_ms": splat_plain_ms,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
