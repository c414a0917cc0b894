#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``comfyui_frame_interpolation_tpu_torch``)
on one NVIDIA GPU: the quickest proof that the port still starts on the card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, one line each; any failed phase raises and the exit code is not 0:

1. device  -- a CUDA device, its name and power limit (``nvidia-smi``);
2. build   -- the warp and splat kernels built from ``csrc/warp.cu`` and
   ``csrc/softsplat.cu``, one ``nvcc`` each, started together; each kernel's
   registers and spills from ``-Xptxas -v``;
3. kernel  -- the warp kernels against their plain PyTorch twin on the card,
   bit for bit (max abs err 0), on the flow cases of ``tests/warp_cases.py``
   (border and zeros, f32 and bf16, at 256x512; tiles whose tap box
   overflows, a 68x92 frame, M2M's widths C = 32 to 384 in zeros mode): the
   kernel ``ops.warp.warp`` routes each case to, and K1 (the tiled kernel)
   forced on every case; and K1, as routed, at the main
   paths' shapes: RIFE's ``[16, 1088, 1920, 7]`` bf16 with f32 and bf16 flow
   and ``[16, 1088, 1920, 3]``, M2M's ``[8, 1088, 1920, 3]`` in zeros mode;
4. node    -- the RIFE VFI node (``rife47.pth``, fast mode, no ensemble,
   random weights from seed 0) on 4 frames of 540x960, multiplier 2, batch 2,
   on the card in fp32 (TF32 off) and bf16, each >= 40 dB PSNR against the
   same node on the CPU (plain twin) in fp32; K1 must have been launched
   exactly 4 times per forward call;
5. golden  -- the port on the card (fp32, TF32 off) against the JAX RIFE 4.7
   output stored in ``tests/fixtures/torch_port_rife47_golden.npz``, >= 40 dB;
6. timing  -- RIFE 4.7 1080p 2x bf16 batch 8 (the configuration of
   ``bench.py:bench_rife``) in frames/s, a ``torch.profiler`` top 10 of one
   forward with K1's device ms and share, and at ``[16, 1088, 1920, 7]`` bf16
   with f32 flow the ms per call of K1, the plain twin and ``F.grid_sample``
   on a precomputed grid (the library yardstick, which the port never
   calls), in turns;
7. splat   -- the splat kernel against its plain twin on the card, on the
   splat cases of ``tests/warp_cases.py`` (256x512 and the narrow frames, f32
   and bf16; flows that pile 16 sources on a target, rough flow) and at the
   M2M path's shape ``[16, 1088, 1920, 4]`` bf16.
   Tolerances: f32 atol 1e-5 on values in [0, 1] (fp32 atomics sum in an
   order that changes from run to run), bf16 one ulp of the output (2**-8 to
   2**-7 of the value);
8. m2m     -- the M2M VFI node (``M2M.pth``, random weights from seed 0) on 4
   frames of 540x960, multipliers 2 and 3, batch 2, on the card in fp32 (TF32
   off) and bf16, each >= 40 dB against the same node on the CPU in fp32;
   original frames pass through bit for bit; exactly 1 splat launch per infer
   call, and per reuse call 4 warp launches on K1 and 16 on the
   wide kernel, as ``models.m2m.warps_per_reuse`` derives them from
   ``warp_kernel.route``;
9. golden  -- the port's M2M on the card (fp32, TF32 off) against the JAX M2M
   output stored in ``tests/fixtures/torch_port_m2m_golden.npz``, >= 40 dB;
10. timing -- M2M 1080p 2x bf16 batch 2 (the configuration of
   ``bench.py:bench_m2m``) in frames/s through ``make_model_fn``, reuse and
   infer ms through ``make_pair_fns``, the splat kernel's ms per call at
   ``[16, 1088, 1920, 4]`` bf16 beside the plain twin's, and a
   ``torch.profiler`` top 10 of one M2M forward with each kernel's device ms
   and share (the splat's ms there is its time on M2M's rough flows).

11. wide     -- the wide-channel warp kernel against the plain twin on the
   card, bit for bit (max abs err 0), on the wide cases of
   ``tests/warp_cases.py`` (C = 32, 64, 192, 448, 960, 46; a channel slice
   whose taps start off 16 bytes; extreme and non-finite flow; border and
   zeros, f32 and bf16, at 128x256) and at FILM's level-0 feature warp
   ``[4, 1080, 1920, 64]`` bf16, where K1 must agree too,
   and, as routed, at M2M's feature warps ``[2, 544, 960, 48]`` and ``[2,
   68, 120, 384]`` bf16 in zeros mode;
12. film     -- the FILM VFI node (``film_net_fp32.pt``, random weights from
   seed 0) on 4 frames of 270x480 (at 540x960 the CPU leg's 7 batch-2 fp32
   calls take about 2 minutes on 8 cores), multipliers 2 and 4, batch 2, on the card
   in fp32 (TF32 off) and bf16, each >= 40 dB against the same node on the
   CPU in fp32; original frames pass through bit for bit; exactly 11 wide and
   5 K1 warp launches per forward call (``film.WARPS_PER_CALL``);
13. golden   -- the port's FILM on the card (fp32, TF32 off) against the JAX
   FILM output stored in ``tests/fixtures/torch_port_film_golden.npz``,
   >= 40 dB;
14. timing   -- FILM 1080p 2x bf16 batch 2 (the configuration of
   ``bench.py:bench_film``) in frames/s, each stage's ms, the wide kernel's,
   K1's, the plain twin's and ``F.grid_sample``'s ms per
   call on the same tensors at ``[4, 1080, 1920, 64]`` and ``[4, 135, 240,
   960]`` bf16, and a ``torch.profiler`` top 10 of one FILM forward with the
   warp kernels' device ms and shares and the idle share.

Each main path (phases 4, 8 and 12) is driven with the launch counts set to
0 just before it and read just after. Each profile (phases 6, 10, 14) also
records the launches of one forward, as the model makes them, and gives
each kernel its device ms there against the bound of those launches; a
ranking line orders kernel and path by the ms above the bound. Then the
kernel table as one JSON line: per kernel its launches (by path), max abs
error, ms, the plain twin's ms,
``grid_sample``'s ms (``library_ms``, null for the splat, which no single
PyTorch call computes), its bound: the larger of the bytes it must move
(inputs once, output once) over 3.35 TB/s and its f32 operations over 67
TFLOP/s, with which of the two bounds it; and ``per_forward``, per path the
launches, device ms, bound and ms above it of one 1080p bf16 forward.
The last line is ``{"ok": true, "device": {...}}``. Nothing of JAX is
imported.
"""

import concurrent.futures
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MAIN_SHAPE = (16, 1088, 1920, 7)  # a batch-8 1080p RIFE warp: 2B images, 3+4 channels
SPLAT_F32_ATOL = 1e-5
SPLAT_SHAPE = (16, 1088, 1920, 4)  # a batch-2 1080p M2M splat: 2 directions x 2 pairs x 4 branches, 3+1 channels
M2M_HW = (540, 960)
FILM_HW = (270, 480)
FILM_WARP_SHAPES = ((4, 1080, 1920, 64), (4, 135, 240, 960))  # FILM 1080p batch 2: level-0 and level-3 feature warps
WIDE_CHANNELS = (32, 64, 192, 448, 960)
M2M_WIDE_SHAPES = ((2, 544, 960, 48), (2, 68, 120, 384))  # M2M 1080p batch 2: encoder-decoder feature warps
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOP_PER_S = 67e12  # f32 outside the tensor cores, same source
# each kernel of the kernels line and its device kernels' names
KERNEL_BODIES = {
    "warp_bilinear": ("warp_bilinear_tiled_kernel",),
    "warp_bilinear_wide": ("warp_bilinear_wide_kernel",),
    "softsplat": ("softsplat_kernel",),
}


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


def bound(nbytes, flops):
    """The least ms the card could take: the larger of the bytes over the
    memory rate and the f32 operations over the f32 rate, and which one."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / F32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def warp_work(planes, flow_planes):
    """Bytes and f32 operations of one warp of ``[N, C, H, W]`` planes: the
    image and flow read once, the output written once; 7 operations per
    channel (4 products, 3 sums) and 14 per pixel for its coordinates and
    weights."""
    n, c, h, w = planes.shape
    nbytes = 2 * planes.numel() * planes.element_size() + flow_planes.numel() * flow_planes.element_size()
    return nbytes, n * h * w * (7 * c + 14)


def splat_work(planes, flow_planes):
    """Bytes and f32 operations of one splat of ``[N, C, H, W]`` planes: the
    values and flow read once, the output written once in the values' dtype;
    8 operations per channel (4 products, 4 sums) and 12 per source."""
    n, c, h, w = planes.shape
    nbytes = 2 * planes.numel() * planes.element_size() + flow_planes.numel() * flow_planes.element_size()
    return nbytes, n * h * w * (8 * c + 12)


def warp_bound(img, flow):
    """Bound of one warp of NHWC ``img`` by ``flow``."""
    return bound(*warp_work(img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)))


@contextlib.contextmanager
def recorded_work(log):
    """Inside, each call of a kernel wrapper appends ``(kernel, bytes, f32
    operations)`` of its launch to ``log``, ``kernel`` named as in the
    kernels line: the launches a model's forward really makes, at the shapes
    it gives them."""
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import softsplat_kernel, warp_kernel

    wrappers = [
        (warp_kernel, "warp_bilinear", "warp_bilinear", warp_work),
        (warp_kernel, "warp_bilinear_wide", "warp_bilinear_wide", warp_work),
        (softsplat_kernel, "softsplat_bilinear", "softsplat", splat_work),
    ]
    real = [getattr(module, attr) for module, attr, _, _ in wrappers]

    def spy(fn, kernel, work):
        def call(x, flow, *args, **kwargs):
            log.append((kernel, *work(x, flow)))
            return fn(x, flow, *args, **kwargs)

        return call

    try:
        for (module, attr, kernel, work), fn in zip(wrappers, real):
            setattr(module, attr, spy(fn, kernel, work))
        yield log
    finally:
        for (module, attr, _, _), fn in zip(wrappers, real):
            setattr(module, attr, fn)


def routed_at_path_shape(shape, mode, flow_dtype, body, generator):
    """``ops.warp.warp`` as routed against the plain twin at a main path's
    NHWC ``shape`` (bf16 values, smooth flow in ``flow_dtype``): the route
    must be ``body`` and the result bit-exact. Returns the max abs error."""
    import torch
    import warp_cases
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import warp_kernel
    from comfyui_frame_interpolation_tpu_torch.ops.warp import warp, warp_torch

    img = torch.rand(shape, generator=generator).to("cuda", torch.bfloat16)
    flow = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=6.0)).to("cuda", flow_dtype)
    planes = img.permute(0, 3, 1, 2)
    routed = warp_kernel.route(planes.shape, planes.stride(), img.dtype)
    check(routed == body, f"{list(shape)} bf16 routed to {routed}, expected {body}")
    got, ref = warp(img, flow, mode), warp_torch(img, flow, mode)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    check(torch.equal(got, ref), f"{routed} kernel vs plain at {list(shape)} bf16 {mode}, {flow_dtype} flow: max err {err}, not bit-exact")
    return err


def grid_sample_call(img, flow, padding_mode="border"):
    """``F.grid_sample`` computing the warp of NHWC ``img`` by ``flow`` on a
    precomputed grid, in the layout the path holds (channels_last planes)."""
    import torch
    import torch.nn.functional as F

    n, h, w, _ = img.shape
    gx = torch.arange(w, device=flow.device, dtype=torch.float32).view(1, 1, w) + flow[..., 0].float()
    gy = torch.arange(h, device=flow.device, dtype=torch.float32).view(1, h, 1) + flow[..., 1].float()
    grid = torch.stack([gx * (2.0 / (w - 1)) - 1.0, gy * (2.0 / (h - 1)) - 1.0], -1).to(img.dtype)
    planes = img.permute(0, 3, 1, 2)
    return lambda: F.grid_sample(planes, grid, mode="bilinear", padding_mode=padding_mode, align_corners=True)


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


def profile_forward(what, model_fn, f0, f1, t, card):
    """``torch.profiler`` over one forward of ``model_fn`` after a warm-up
    forward whose kernel launches are recorded: the top 10 ops by device
    time, each hand kernel's device ms and share of the device time, the
    device's idle share of the wall time; and per kernel of the kernels line
    that the forward launched, its launches, device ms and bound (the bytes
    and operations of its recorded launches) and the ms above it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def device_us(evt):
        return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)

    log = []
    with recorded_work(log):
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
    body_us = {
        body: sum(device_us(e) for e in on_device if body in e.key) for bodies in KERNEL_BODIES.values() for body in bodies
    }
    shares = ", ".join(
        f"{body} {us / 1e3:.3f} ms ({100 * us / device_total:.2f} %)" for body, us in body_us.items() if us > 0
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
    per_kernel = {}
    for kernel, bodies in KERNEL_BODIES.items():
        work = [(nbytes, ops_) for k, nbytes, ops_ in log if k == kernel]
        if not work:
            continue
        b = bound(sum(w[0] for w in work), sum(w[1] for w in work))
        dev_ms = sum(body_us[body] for body in bodies) / 1e3
        per_kernel[kernel] = {"launches": len(work), "device_ms": dev_ms, "bound_ms": b[0], "bound_by": b[1], "above_bound_ms": dev_ms - b[0]}
        print(
            f"  profile kernel {kernel}: {len(work)} launches, {dev_ms:.3f} ms on the device, bound {b[0]:.3f} ms "
            f"({b[1]}), {dev_ms - b[0]:.3f} ms above it",
            flush=True,
        )
    return per_kernel


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
    for name in ("warp", "softsplat"):
        log = next((v for k, v in build.build_logs.items() if k[0] == name), "")
        for line in build.ptxas_summary(log) or ["built before this process: no ptxas log"]:
            print(f"build {card}: {name}.cu {line}", flush=True)

    # ---- 3. kernel vs plain on the card --------------------------------------
    n_cases, bodies = 0, {}
    for case in warp_cases.warp_cases(0, 256, 512):
        for mode in case["modes"]:
            for dtype in (torch.float32, torch.bfloat16):
                img = torch.from_numpy(case["img"]).to(dev, dtype)
                flow = torch.from_numpy(case["flow"]).to(dev)
                planes, fplanes = img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)
                routed = warp_kernel.route(planes.shape, planes.stride(), dtype)
                bodies[routed] = bodies.get(routed, 0) + 1
                ref = warp_torch(img, flow, mode)
                outs = {
                    f"routed ({routed})": warp(img, flow, mode),
                    "K1": warp_kernel.warp_bilinear(planes, fplanes, mode == "zeros").permute(0, 2, 3, 1),
                }
                torch.cuda.synchronize()
                for body, got in outs.items():
                    err = (got.float() - ref.float()).abs().max().item()
                    check(torch.equal(got, ref), f"kernel vs plain: {case['name']} {mode} {dtype} {body}: max err {err}, not bit-exact")
                n_cases += 1
    g = torch.Generator().manual_seed(0)
    main_img = torch.rand(MAIN_SHAPE, generator=g).to(dev, torch.bfloat16)
    main_flow = torch.from_numpy(warp_cases.smooth_flow(*MAIN_SHAPE[:3], amp=6.0)).to(dev)
    got, ref = warp(main_img, main_flow), warp_torch(main_img, main_flow)
    torch.cuda.synchronize()
    main_err = (got.float() - ref.float()).abs().max().item()
    check(torch.equal(got, ref), f"K1 vs plain at {MAIN_SHAPE}: max err {main_err}, not bit-exact")
    del got, ref
    # K1's C = 7 and C = 3 builds at the other shapes and flows
    # of the main paths: RIFE's bf16 model (bf16 flow), RIFE's image warp,
    # M2M's image warps (zeros)
    path_errs = {
        f"{list(shape)} {mode} {str(fd).split('.')[-1]} flow": routed_at_path_shape(shape, mode, fd, "tiled", g)
        for shape, mode, fd in (
            (MAIN_SHAPE, "border", torch.bfloat16),
            ((16, 1088, 1920, 3), "border", torch.float32),
            ((16, 1088, 1920, 3), "border", torch.bfloat16),
            ((8, 1088, 1920, 3), "zeros", torch.bfloat16),
        )
    }
    print(
        f"kernel vs plain: {n_cases} case x mode x dtype runs at 256x512 (routed to {bodies}), the routed kernel "
        f"and K1 each bit-exact (max err 0); {list(MAIN_SHAPE)} bf16 K1 max err {main_err}; "
        f"K1 at the paths' shapes, bf16: " + ", ".join(f"{k} max err {v}" for k, v in path_errs.items()),
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
    warp_kernel.launches = warp_kernel.wide_launches = 0
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
        f"cuda bf16 vs cpu fp32 {p16:.2f} dB; K1 launches {rife_warp_launches} = 4 x {2 * calls_per_run} forward "
        f"calls",
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
    rife_profile = profile_forward("RIFE 4.7 1080p bf16 b8", model_fn, f0, f1, t, card)
    del f0, f1
    # plain, K1, grid_sample, grid_sample, K1, plain
    calls = {
        "plain": (lambda: warp_torch(main_img, main_flow), 5),
        "K1": (lambda: warp(main_img, main_flow), 50),
        "grid_sample": (grid_sample_call(main_img, main_flow), 20),
    }
    order = ["plain", "K1", "grid_sample"]
    k1_times = {k: [] for k in order}
    for name in order + order[::-1]:
        fn, iters = calls[name]
        k1_times[name].append(cuda_ms(fn, iters))
    del calls
    k1_ms = {k: statistics.mean(v) for k, v in k1_times.items()}
    k1_bound = warp_bound(main_img, main_flow)
    print(
        f"timing {card}: RIFE 4.7 1080p 2x bf16 batch 8 {fps:.2f} frames/s; warp {list(MAIN_SHAPE)} bf16, f32 flow: "
        + ", ".join(f"{k} {k1_ms[k]:.4f} ms {k1_times[k]}" for k in order)
        + f"; bound {k1_bound[0]:.4f} ms ({k1_bound[1]}), K1 at {100 * k1_bound[0] / k1_ms['K1']:.1f} % of it",
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
    warp_kernel.launches = warp_kernel.wide_launches = softsplat_kernel.launches = 0
    for multiplier in (2, 3):
        for dtype in ("float32", "bfloat16"):
            (outs[multiplier, dtype],) = node.vfi(
                "M2M.pth", frames, multiplier=multiplier, batch_size=batch, dtype=dtype, params=m2m_params, device="cuda"
            )
    torch.cuda.synchronize()
    m2m_warp_launches, m2m_wide = warp_kernel.launches, warp_kernel.wide_launches
    m2m_splat_launches = softsplat_kernel.launches
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    split = m2m.warps_per_reuse(torch.float32)
    check(split == m2m.warps_per_reuse(torch.bfloat16), "M2M's warp split differs between fp32 and bf16")
    check(
        m2m_splat_launches == expect_infer,
        f"splat launches {m2m_splat_launches} != 1 x {expect_infer} infer calls",
    )
    check(
        m2m_warp_launches == split["narrow"] * expect_reuse,
        f"K1 launches {m2m_warp_launches} != {split['narrow']} x {expect_reuse} reuse calls",
    )
    check(
        m2m_wide == split["wide"] * expect_reuse,
        f"wide warp launches {m2m_wide} != {split['wide']} x {expect_reuse} reuse calls",
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
        f"(cpu leg {cpu_s:.1f} s); splat launches {m2m_splat_launches} = 1 x {expect_infer} infer calls; "
        f"warp launches per reuse call {split}: K1 {m2m_warp_launches}, wide {m2m_wide}, "
        f"over {expect_reuse} reuse calls",
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
    splat_bound = bound(*splat_work(splat_vals.permute(0, 3, 1, 2), splat_flow.permute(0, 3, 1, 2)))
    del splat_vals, splat_flow
    print(
        f"timing {card}: M2M 1080p 2x bf16 batch 2 {m2m_fps:.3f} frames/s; reuse {reuse_ms:.3f} ms, infer "
        f"{infer_ms:.3f} ms per pair batch; splat {list(SPLAT_SHAPE)} bf16 kernel {splat_ms:.4f} ms "
        f"({splat_kern_a:.4f}, {splat_kern_b:.4f}), plain {splat_plain_ms:.4f} ms ({splat_plain_a:.4f}, {splat_plain_b:.4f})",
        flush=True,
    )
    print(
        f"timing {card}: splat {list(SPLAT_SHAPE)} bf16 bound {splat_bound[0]:.4f} ms ({splat_bound[1]}: values and "
        f"flow in, bf16 out), the op at {100 * splat_bound[0] / splat_ms:.1f} % of it",
        flush=True,
    )
    m2m_profile = profile_forward("M2M 1080p bf16 b2", model_fn, f0, f1, t, card)
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
    k1 = warp_kernel.warp_bilinear(wide_img.permute(0, 3, 1, 2), wide_flow.permute(0, 3, 1, 2))
    k1 = k1.permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    wide_err = (got.float() - ref.float()).abs().max().item()
    k1_err = (k1.float() - ref.float()).abs().max().item()
    check(torch.equal(got, ref), f"wide kernel vs plain at {FILM_WARP_SHAPES[0]}: max err {wide_err}, not bit-exact")
    check(torch.equal(k1, ref), f"K1 vs plain at {FILM_WARP_SHAPES[0]}: max err {k1_err}, not bit-exact")
    del got, ref, k1
    # M2M's feature warps, which the route sends to the wide kernel (zeros,
    # bf16 flow): the encoder-decoder's first and last levels
    m2m_errs = {
        f"{list(shape)}": routed_at_path_shape(shape, "zeros", torch.bfloat16, "wide", g)
        for shape in M2M_WIDE_SHAPES
    }
    print(
        f"wide kernel vs plain: {n_cases} cases at 128x256 (C {', '.join(map(str, WIDE_CHANNELS))}, 46, unaligned, "
        f"extreme, non-finite) bit-exact (max err 0); {list(FILM_WARP_SHAPES[0])} bf16 max err wide {wide_err}, "
        f"K1 {k1_err}; routed to it at M2M's shapes, bf16 zeros, bf16 flow: "
        + ", ".join(f"{k} max err {v}" for k, v in m2m_errs.items()),
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
        f"K1 launches {film_warp_launches} != {film.WARPS_PER_CALL['narrow']} x {film_calls} forward calls",
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
        f"{film_calls} forward calls, K1 launches {film_warp_launches} = "
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
        # plain, wide, K1, grid_sample, then back: the versions in turns
        planes, fplanes = wide_img.permute(0, 3, 1, 2), wide_flow.permute(0, 3, 1, 2)
        calls = {
            "plain": (lambda: warp_torch(wide_img, wide_flow), 3),
            "wide": (lambda: warp(wide_img, wide_flow, prefer_wide=True), 30),
            "K1": (lambda: warp_kernel.warp_bilinear(planes, fplanes), 10),
            "grid_sample": (grid_sample_call(wide_img, wide_flow), 10),
        }
        order = ["plain", "wide", "K1", "grid_sample"]
        times = {k: [] for k in order}
        for name in order + order[::-1]:
            fn, iters = calls[name]
            times[name].append(cuda_ms(fn, iters))
        del calls, planes, fplanes
        key = "x".join(map(str, shape))
        wb = warp_bound(wide_img, wide_flow)
        wide_times[key] = {
            "ms": statistics.mean(times["wide"]),
            "k1_ms": statistics.mean(times["K1"]),
            "plain_ms": statistics.mean(times["plain"]),
            "library_ms": statistics.mean(times["grid_sample"]),
            "bound_ms": wb[0],
            "bound_by": wb[1],
        }
        print(
            f"timing {card}: warp {list(shape)} bf16, f32 flow: "
            + ", ".join(f"{k} {statistics.mean(times[k]):.4f} ms {times[k]}" for k in order)
            + f"; bound {wb[0]:.4f} ms ({wb[1]}), wide at {100 * wb[0] / wide_times[key]['ms']:.1f} % of it",
            flush=True,
        )
    del wide_img, wide_flow
    film_profile = profile_forward("FILM 1080p bf16 b2", model_fn, f0, f1, t, card)
    del f0, f1
    wide_main = wide_times["x".join(map(str, FILM_WARP_SHAPES[0]))]
    # per kernel and 1080p bf16 path, one forward's launches, device ms and
    # bound, ranked by the ms above the bound
    profiles = {"rife": rife_profile, "m2m": m2m_profile, "film": film_profile}
    per_forward = {k: {path: prof[k] for path, prof in profiles.items() if k in prof} for k in KERNEL_BODIES}
    ranked = sorted(
        ((k, path, v) for k, paths in per_forward.items() for path, v in paths.items()),
        key=lambda e: e[2]["above_bound_ms"], reverse=True,
    )
    print(
        f"ranking {card}: ms above the bound per 1080p bf16 forward: "
        + "; ".join(f"{k} on {path} {v['above_bound_ms']:.3f} ({v['launches']} launches)" for k, path, v in ranked),
        flush=True,
    )

    print(json.dumps({"kernels": [
        {
            "name": "warp_bilinear",
            "route": "cuda",
            "source": "comfyui_frame_interpolation_tpu_torch/csrc/warp.cu",
            "replaces": "comfyui_frame_interpolation_tpu/ops/pallas/warp_kernel.py:78",
            "launches": rife_warp_launches + m2m_warp_launches + film_warp_launches,
            "launches_by_path": {"rife": rife_warp_launches, "m2m": m2m_warp_launches, "film": film_warp_launches},
            "max_abs_err": main_err,
            "shape": f"{list(MAIN_SHAPE)} bf16, f32 flow",
            "ms": k1_ms["K1"],
            "plain_ms": k1_ms["plain"],
            "bound_ms": k1_bound[0],
            "bound_by": k1_bound[1],
            "library_ms": k1_ms["grid_sample"],
            "per_forward": per_forward["warp_bilinear"],
        },
        {
            "name": "warp_bilinear_wide",
            "route": "cuda",
            "source": "comfyui_frame_interpolation_tpu_torch/csrc/warp.cu",
            "replaces": "comfyui_frame_interpolation_tpu/ops/pallas/warp_kernel.py:297",
            "launches": m2m_wide + film_wide_launches,
            "launches_by_path": {"m2m": m2m_wide, "film": film_wide_launches},
            "max_abs_err": wide_err,
            "shape": f"{list(FILM_WARP_SHAPES[0])} bf16, f32 flow",
            "ms": wide_main["ms"],
            "plain_ms": wide_main["plain_ms"],
            "k1_ms": wide_main["k1_ms"],
            "bound_ms": wide_main["bound_ms"],
            "bound_by": wide_main["bound_by"],
            "library_ms": wide_main["library_ms"],
            "by_shape": wide_times,
            "per_forward": per_forward["warp_bilinear_wide"],
        },
        {
            "name": "softsplat",
            "route": "cuda",
            "source": "comfyui_frame_interpolation_tpu_torch/csrc/softsplat.cu",
            "replaces": "comfyui_frame_interpolation_tpu/ops/pallas/softsplat_kernel.py:365",
            "launches": m2m_splat_launches,
            "launches_by_path": {"m2m": m2m_splat_launches},
            "max_abs_err": splat_err,
            "shape": f"{list(SPLAT_SHAPE)} bf16, f32 flow, smooth amp 8, through softsplat_func",
            "ms": splat_ms,
            "plain_ms": splat_plain_ms,
            "kernel_ms_in_m2m_forward": m2m_profile["softsplat"]["device_ms"],
            "bound_ms": splat_bound[0],
            "bound_by": splat_bound[1],
            "library_ms": None,
            "per_forward": per_forward["softsplat"],
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
