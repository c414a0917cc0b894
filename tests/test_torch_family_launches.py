"""The hand-kernel launches that ``chip_smoke.py`` phases 55-61 and 64-70
expect of one training step of each family (``chip_smoke.FAMILY_STEP_LAUNCHES``), derived
on the CPU from the models themselves.

On the card every warp of a step launches the kernel that
``ops.cuda.warp_kernel.route`` names for its shape, strides and dtype (K1,
"narrow", or the wide kernel), every splat launches K2, and the backward
kernels launch once for each warp or splat whose output gradient autograd
computes: a warp whose output only a comparison reads (a mask) gets no
backward launch. Here the same step runs on the CPU through the plain twins,
with each family's warps and splats wrapped to count what the card would
launch: the route of each warp, and an identity autograd node on each
output that counts the backward calls. The counts must equal the table,
and the forward counts must equal the models' own counts
(``warps_per_*``/``splats_per_*`` at f32; CAIN, FLAVR, Sepconv and MoMo
none). The steps run at b1 x 64x64 (STMFNet and CAIN 128x128; STMFNet with
oneDNN off: ``test_torch_stmfnet_train``'s docstring says why); launch
counts do not depend on the size.
"""

import contextlib
import importlib
import os
import sys

import pytest
import torch

from comfyui_frame_interpolation_tpu_torch.models import amt, atm, eisai, film, gmfss, ifrnet, ifunet, rife, stmfnet, xvfi
from comfyui_frame_interpolation_tpu_torch.ops.cuda import warp_kernel
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)
from torch_train_cases import release_module_caches  # noqa: F401  (autouse: drops the caches after the module)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the script at the repository's root; it imports nothing heavy)

F32 = torch.float32


class _Tap(torch.autograd.Function):
    """The identity, counting its backward calls into ``counts[key]``."""

    @staticmethod
    def forward(ctx, x, counts, key):
        ctx.counts, ctx.key = counts, key
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.counts[ctx.key] += 1
        return g, None, None


@contextlib.contextmanager
def _counted(counts):
    splat_mod = importlib.import_module("comfyui_frame_interpolation_tpu_torch.ops.softsplat")
    real_splat = splat_mod.softsplat_func

    def counted_warp(real):
        def call(img, flow, padding_mode="border", prefer_wide=False):
            planes = img.permute(0, 3, 1, 2)
            counts["wide" if warp_kernel.route(planes.shape, planes.stride(), planes.dtype, prefer_wide) == "wide" else "narrow"] += 1
            out = real(img, flow, padding_mode, prefer_wide)
            return _Tap.apply(out, counts, "backward") if out.requires_grad else out

        return call

    def counted_splat(x, flow):
        counts["splat"] += 1
        out = real_splat(x, flow)
        return _Tap.apply(out, counts, "splat_backward") if out.requires_grad else out

    # IFUnet and AMT warp through ifrnet.warp_nchw
    targets = [(m, "warp", counted_warp(m.warp)) for m in (gmfss, eisai, rife, xvfi, stmfnet, ifrnet, film, atm)]
    targets += [(splat_mod, "softsplat_func", counted_splat), (xvfi, "softsplat_func", counted_splat)]
    real = [getattr(m, a) for m, a, _ in targets]
    try:
        for m, a, fn in targets:
            setattr(m, a, fn)
        yield
    finally:
        for (m, a, _), fn in zip(targets, real):
            setattr(m, a, fn)


def _forward_counts(name):
    """The models' own counts of one forward's warps and splats at f32."""
    xv = "XVFInet_Vimeo_exp1_latest.pt"
    warps = {
        "gmfss": lambda: [gmfss.warps_per_reuse(F32), gmfss.warps_per_infer(False, F32)],
        "gmfss_union": lambda: [gmfss.warps_per_reuse(F32), gmfss.warps_per_infer(True, F32)],
        "eisai": lambda: [eisai.warps_per_infer()],
        "xvfi": lambda: [xvfi.warps_per_reuse(xv, F32), xvfi.warps_per_infer(F32)],
        "stmfnet": lambda: [stmfnet.warps_per_forward(F32)],
        "ifrnet": lambda: [ifrnet.warps_per_forward("S", F32)],
        "amt": lambda: [amt.warps_per_forward("S", F32)],
        "film": lambda: [film.warps_per_forward(F32)],
        "ifunet": lambda: [ifunet.warps_per_forward(F32)],
        "atm": lambda: [atm.warps_per_forward("base", True, False, F32)],
    }.get(name, list)()
    splats = {"gmfss": gmfss.splats_per_infer, "gmfss_union": gmfss.splats_per_infer, "eisai": eisai.splats_per_infer,
              "xvfi": xvfi.splats_per_infer, "stmfnet": stmfnet.splats_per_forward}.get(name, lambda: 0)()
    return {"narrow": sum(w.get("narrow", 0) for w in warps), "wide": sum(w.get("wide", 0) for w in warps), "splat": splats}


@pytest.mark.parametrize("name", chip_smoke.FAMILIES)
def test_family_step_launches_match_the_table(name):
    counts = dict.fromkeys(("narrow", "wide", "splat", "backward", "splat_backward"), 0)
    batch = chip_smoke.family_batch(name, 1, chip_smoke.FAMILY_CHECK_HW.get(name, (64, 64)), 0, "cpu")
    with _counted(counts), torch.backends.mkldnn.flags(enabled=name != "stmfnet"):
        _, step = chip_smoke.family_trainer(name, "cpu")
        loss = step(*batch)
    assert torch.isfinite(loss)
    assert counts == chip_smoke.FAMILY_STEP_LAUNCHES[name]
    assert {k: counts[k] for k in ("narrow", "wide", "splat")} == _forward_counts(name)


def _step_counts(name, hw, dtype=None, params=None):
    counts = dict.fromkeys(("narrow", "wide", "splat", "backward", "splat_backward"), 0)
    frames, t, target = chip_smoke.family_batch(name, 1, hw, 0, "cpu")
    if dtype is not None:
        frames, t, target = [f.to(dtype) for f in frames], t.to(dtype), target.to(dtype)
    with _counted(counts), torch.backends.mkldnn.flags(enabled=name != "stmfnet"):
        _, step = chip_smoke.family_trainer(name, "cpu", dtype=dtype, eisai_iters=2, momo_run=("momo-lite.pth", 2), params=params)
        loss = step(frames, t, target)
    assert torch.isfinite(loss)
    return counts


@pytest.mark.parametrize("name", chip_smoke.VARIANT_STEPS)
def test_variant_step_launches_match_the_table(name):
    """Phase 95's table (``chip_smoke.VARIANT_STEP_LAUNCHES``), derived the
    same way at b1 x 64x64 (X4K at 512x512); RIFE 4.0's restart on weights
    whose stage-1 update takes it (``chip_smoke.rife40_restart_params``)."""
    hw = chip_smoke.VARIANT_HW.get(name, (64, 64))
    params = None
    if name == "rife40_restart":
        frames, t, _ = chip_smoke.family_batch(name, 1, hw, 0, "cpu")
        params, _ = chip_smoke.rife40_restart_params(*frames, t)
    assert _step_counts(name, hw, params=params) == chip_smoke.VARIANT_STEP_LAUNCHES[name]


@pytest.mark.parametrize("name", [n for n in chip_smoke.FAMILIES if n != "stmfnet"])
def test_bf16_step_launches_match_the_table(name):
    """Phase 94's bf16 steps launch what the f32 steps do: every warp routes
    to the same kernel in bf16 (the wide kernel takes whole 16-byte vectors
    or 32 bytes a pixel, which the families' wide features have in either
    dtype; their frames and masks stay on K1). STMFNet's bf16 step takes
    ~107 s on this CPU with oneDNN off (``tests/test_torch_bf16_train.py``
    says why it must be off), so phase 94 alone holds its launches."""
    hw = chip_smoke.FAMILY_CHECK_HW.get(name, (64, 64))
    assert _step_counts(name, hw, torch.bfloat16) == chip_smoke.FAMILY_STEP_LAUNCHES[name]
