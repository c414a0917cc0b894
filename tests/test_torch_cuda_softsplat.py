"""The hand-written Hopper forward-splat kernel against its plain twin, on the
card.

Marked ``cuda``; every test skips when ``torch.cuda.is_available()`` is
false (decided inside the fixture, never at import). Run on a machine with
an H100::

    python -m pytest --noconftest tests/test_torch_cuda_softsplat.py -m cuda -q

Tolerances: f32 atol 1e-5 on values in [0, 1] (the sums are fp32 atomics in
an order that changes from run to run, each pixel taking at most a few dozen
contributions); bf16/f16 one ulp of the output (the kernel and the twin round
their f32 sums once, and sums that differ in the last f32 bit can round to
neighbouring values). The twin's ``index_add_`` on the card is atomic too.

The cases cover each path of the kernel: for C <= 4 the row and column
merges of the corners that neighbouring sources share (smooth flow, where
most corners merge; 16 sources piled onto each target; rough flow, where few
merge), wider inputs whose corners all go straight to global memory (C = 6,
8, 66); float4 atomics (C = 4 NHWC), float2 and scalar tails (C = 1, 2, 3,
6), and NCHW planes, which take scalar atomics.

GMFSS Fortuna's widths, C = 65, 129 and 193 (each feature level and its
``exp(metric)`` channel), take the branch for wide inputs: every corner of
every source straight to global memory. They are held in f32, bf16 and f16
on rough flow, as contiguous NHWC, as an NHWC channel slice of a wider
tensor (pixel stride not a multiple of 16 bytes) and as ``channels_last``
planes; and a GMFSS forward, base and union, launches the splat 8 times per
infer call and the warps of ``gmfss.warps_per_reuse`` and
``gmfss.warps_per_infer``.

EISAI's widths, C = 6, 66, 258 and 514 (RGB + NEDT or a ResNet level, the
ones channel and ``exp(metric)``), f32 as EISAI splats them and bf16; an
EISAI forward launches the splat 8 times per infer call, K1 twice
(``eisai.warps_per_infer``) and nothing per reuse call; and RIFE 4.0 makes
the warps of ``rife.warps_per_forward``, with the refinement's 4 on the
wide kernel and one more K1 warp when its restart is taken.

STMFNet's splat, ``[2, 1152, 1920, 4]`` (both frames of a 1080p batch-1
window: 3 channels times ``exp(metric)``, and the metric), f32 and bf16; an
STMFNet forward through the window executor launches, per call, the K1 and
wide warps of ``stmfnet.warps_per_forward`` and one splat; a FLAVR forward
launches none.

XVFI's CFR splat, both directions of a 1080p batch-2 infer as one batch:
``[4, 544, 960, 3]`` for Vimeo and ``[4, 384, 512, 3]`` for X4K, f32 (the
flow times ``z`` and the gaussian norm), on smooth flow; and XVFI's pair
functions, Vimeo and X4K, launch the warps of ``xvfi.warps_per_reuse`` per
reuse call and of ``xvfi.warps_per_infer`` and one splat per infer call.

The splat's backward kernel (``softsplat_kernel.softsplat_bilinear_backward``)
against its plain version (``ops.softsplat.softsplat_backward_torch``) on the
splat cases and ``warp_cases.splat_backward_cases`` at 256x512 (f32 and
bf16, f16 once), C = 1-8, 65, 66, 193, 258 and 514 (each vector width the
kernel picks: 4, 2 or 1 channels, one vector a source or several), NHWC
views, NCHW planes, channel slices that start 4 and 8 bytes past a 16-byte
boundary and an expanded ``grad_out``, and without the input's gradient
(the flow's the same bits). Tolerances: the input's gradient within 4 f32 ulps of
the sum of its absolute contributions (at most four products summed in
another order); the flow's within 1e-5 of its largest magnitude plus 1e-6
(channel sums in another order); bf16/f16 one ulp of the output more. The
kernel uses no atomics: two launches are equal bit for bit. A CUDA splat
that needs a gradient goes through ``SplatFunction`` (the twin is never
called), and one M2M training step makes its launches: K1 4, wide 16 and
the splat 1 forward, the warp's backward 20 and the splat's 1.

K2 with a band of sources (``row0``, ``out_rows``) on 2 and 3 bands, f32
and bf16, against the twin's band; the partials' sum against the
whole-frame kernel and ``softsplat_func``; the same on the wide-channel
route (C > 4) at GMFSS's C = 65 and 193 in bf16 and EISAI's 514 in f32;
the splat's backward on the same bands (C = 4 f32 and bf16, 65 and 66
f32): each band's launch on the whole frame's output gradient the
whole-frame launch's rows bit for bit, ``row0 = 0`` at the whole height
the default call bit for bit, each band against its plain version; the
bands' partials through ``softsplat_partial`` with a gradient give the
whole frame's gradients bit for bit, one backward launch a band;
and M2M's pair functions on a
``(1, 2)`` mesh of replicas of the card against one device (f32, TF32 off,
1e-4), K1 8, the wide kernel 32 and K2 2 a pair batch.
"""

import importlib
import math

import pytest
import torch

import warp_cases
from comfyui_frame_interpolation_tpu_torch.core import loop
from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_timestep, plan_window4
from comfyui_frame_interpolation_tpu_torch.models import eisai, flavr, gmfss, m2m, rife, stmfnet, xvfi
from comfyui_frame_interpolation_tpu_torch.ops.cuda import softsplat_kernel, warp_kernel
from comfyui_frame_interpolation_tpu_torch.ops.softsplat import softsplat_backward_torch, softsplat_func, softsplat_partial, softsplat_torch

pytestmark = pytest.mark.cuda

F32_ATOL = 1e-5
MANTISSA_BITS = {torch.bfloat16: 7, torch.float16: 10}
CASES = warp_cases.splat_cases(0, 256, 512)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(kernel_out, plain_out, dtype):
    torch.cuda.synchronize()
    assert kernel_out.dtype == plain_out.dtype == dtype
    err = (kernel_out.float() - plain_out.float()).abs()
    if dtype == torch.float32:
        assert err.max().item() <= F32_ATOL, err.max().item()
    else:
        _, exp = torch.frexp(plain_out.float().abs())
        ulp = torch.ldexp(torch.ones_like(err), exp - 1 - MANTISSA_BITS[dtype])
        assert bool((err <= ulp).all()), err.max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_kernel_matches_twin(cuda, name, dtype):
    case = next(c for c in CASES if c["name"] == name)
    vals = torch.from_numpy(case["vals"]).to(cuda, dtype)
    flow = torch.from_numpy(case["flow"]).to(cuda)
    _check(softsplat_func(vals, flow), softsplat_torch(vals, flow), dtype)


@pytest.mark.parametrize("flow_dtype", [torch.bfloat16, torch.float16])
def test_low_precision_flow(cuda, flow_dtype):
    case = CASES[2]
    vals = torch.from_numpy(case["vals"]).to(cuda, torch.bfloat16)
    flow = torch.from_numpy(case["flow"]).to(cuda, flow_dtype)
    _check(softsplat_func(vals, flow), softsplat_torch(vals, flow), torch.bfloat16)


def test_layouts_agree_and_launches_are_counted(cuda):
    case = CASES[2]
    vals = torch.from_numpy(case["vals"]).to(cuda)
    flow = torch.from_numpy(case["flow"]).to(cuda)
    before = softsplat_kernel.launches
    nhwc = softsplat_func(vals, flow)
    planes = softsplat_kernel.softsplat_bilinear(
        vals.permute(0, 3, 1, 2).contiguous(), flow.permute(0, 3, 1, 2).contiguous()
    )
    assert softsplat_kernel.launches == before + 2
    assert planes.dtype == torch.float32 and planes.is_contiguous()
    torch.cuda.synchronize()
    assert (planes.permute(0, 2, 3, 1) - nhwc).abs().max().item() <= F32_ATOL


@pytest.mark.parametrize("c", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("layout", ["nhwc", "nchw_planes"])
@pytest.mark.parametrize("flow_name", ["smooth_amp8_c4", "rough_x40_c4", "pile_4x4_c4"])
def test_vector_and_scalar_atomic_layouts(cuda, c, layout, flow_name):
    case = next(x for x in CASES if x["name"] == flow_name)
    flow = torch.from_numpy(case["flow"]).to(cuda)
    vals = torch.rand(*flow.shape[:3], c, generator=torch.Generator().manual_seed(c)).to(cuda)
    ref = softsplat_torch(vals, flow)
    if layout == "nhwc":
        got = softsplat_func(vals, flow)
    else:
        planes = softsplat_kernel.softsplat_bilinear(
            vals.permute(0, 3, 1, 2).contiguous(), flow.permute(0, 3, 1, 2).contiguous()
        )
        assert planes.is_contiguous()  # channel stride H*W: scalar atomics
        got = planes.permute(0, 2, 3, 1)
    _check(got, ref, torch.float32)


def test_main_path_shape(cuda):
    g = torch.Generator().manual_seed(0)
    vals = torch.rand(16, 1088, 1920, 4, generator=g).to(cuda, torch.bfloat16)
    flow = torch.from_numpy(warp_cases.smooth_flow(16, 1088, 1920, 8.0)).to(cuda)
    _check(softsplat_func(vals, flow), softsplat_torch(vals, flow), torch.bfloat16)


def test_kernel_rejects_what_it_does_not_take(cuda):
    vals = torch.rand(1, 3, 8, 8, device=cuda)
    flow = torch.zeros(1, 2, 8, 8, device=cuda)
    with pytest.raises(TypeError):
        softsplat_kernel.softsplat_bilinear(vals.double(), flow)
    with pytest.raises(ValueError):
        softsplat_kernel.softsplat_bilinear(vals, flow[:, :1])
    with pytest.raises(ValueError, match="CUDA"):
        softsplat_kernel.softsplat_bilinear(vals, flow.cpu())
    with pytest.raises(ValueError, match="cuda or cpu"):
        softsplat_func(vals.permute(0, 2, 3, 1).cpu(), flow.permute(0, 2, 3, 1))
    with pytest.raises(NotImplementedError):
        softsplat_kernel.softsplat_bilinear(vals.requires_grad_(), flow)


def test_m2m_launch_counts(cuda):
    """One splat per infer call, 20 warps per reuse call (4 on K1, 16 on the
    wide kernel), through the node's executor at x3 (three pairs, two
    timesteps each, batch 2)."""
    reuse_fn, infer_fn = m2m.make_pair_fns(m2m.init_params(0), device=cuda)
    frames = torch.rand(4, 64, 128, 3, device=cuda)
    plan = plan_timestep(4, 3)
    _, by_count = loop._pair_groups(plan)
    reuse_calls = sum(math.ceil(len(keys) / 2) for keys in by_count.values())
    infer_calls = sum(m * math.ceil(len(keys) / 2) for m, keys in by_count.items())
    warps, wide, splats = warp_kernel.launches, warp_kernel.wide_launches, softsplat_kernel.launches
    out = loop.run_plan_pair_cached(frames, plan, reuse_fn, infer_fn, batch_size=2)
    torch.cuda.synchronize()
    split = m2m.warps_per_reuse()
    assert (reuse_calls, infer_calls) == (2, 4) and split == {"narrow": 4, "wide": 16}
    assert warp_kernel.launches - warps == split["narrow"] * reuse_calls
    assert warp_kernel.wide_launches - wide == split["wide"] * reuse_calls
    assert softsplat_kernel.launches - splats == infer_calls
    assert out.shape == (10, 64, 128, 3) and torch.isfinite(out).all()


@pytest.mark.parametrize("c", [65, 129, 193])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("layout", ["nhwc", "nhwc_channel_slice", "channels_last"])
def test_gmfss_widths(cuda, c, dtype, layout):
    case = next(x for x in CASES if x["name"] == "rough_x40_c4")
    flow = torch.from_numpy(case["flow"]).to(cuda)
    g = torch.Generator().manual_seed(c)
    if layout == "nhwc_channel_slice":
        vals = torch.rand(*flow.shape[:3], c + 3, generator=g).to(cuda, dtype)[..., 1 : c + 1]
    else:
        vals = torch.rand(*flow.shape[:3], c, generator=g).to(cuda, dtype)
    ref = softsplat_torch(vals, flow)
    if layout == "channels_last":
        planes = vals.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        out = softsplat_kernel.softsplat_bilinear(planes, flow.permute(0, 3, 1, 2))
        assert out.stride(1) == 1  # the output keeps the input's layout
        got = out.permute(0, 2, 3, 1).to(dtype)
    else:
        got = softsplat_func(vals, flow)
    _check(got, ref, dtype)


@pytest.mark.parametrize("union", [False, True])
def test_gmfss_launch_counts(cuda, union):
    """Through the node's executor at x3 (three pairs, two timesteps each,
    batch 2): the warps of ``warps_per_reuse`` per reuse call, those of
    ``warps_per_infer`` and 8 splats per infer call."""
    reuse_fn, infer_fn = gmfss.make_pair_fns(gmfss.init_params(0, union=union), union=union, device=cuda)
    frames = torch.rand(4, 64, 128, 3, device=cuda)
    plan = plan_timestep(4, 3)
    _, by_count = loop._pair_groups(plan)
    reuse_calls = sum(math.ceil(len(keys) / 2) for keys in by_count.values())
    infer_calls = sum(m * math.ceil(len(keys) / 2) for m, keys in by_count.items())
    warps, wide, splats = warp_kernel.launches, warp_kernel.wide_launches, softsplat_kernel.launches
    out = loop.run_plan_pair_cached(frames, plan, reuse_fn, infer_fn, batch_size=2)
    torch.cuda.synchronize()
    per_reuse, per_infer = gmfss.warps_per_reuse(), gmfss.warps_per_infer(union)
    assert per_reuse == {"narrow": 4, "wide": 2} and per_infer == {"narrow": 4 if union else 0, "wide": 0}
    assert warp_kernel.launches - warps == per_reuse["narrow"] * reuse_calls + per_infer["narrow"] * infer_calls
    assert warp_kernel.wide_launches - wide == per_reuse["wide"] * reuse_calls
    assert softsplat_kernel.launches - splats == gmfss.splats_per_infer() * infer_calls == 8 * infer_calls
    assert out.shape == (10, 64, 128, 3) and torch.isfinite(out).all()


@pytest.mark.parametrize("c", [6, 66, 258, 514])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eisai_widths(cuda, c, dtype):
    case = next(x for x in CASES if x["name"] == "rough_x40_c4")
    flow = torch.from_numpy(case["flow"]).to(cuda)
    g = torch.Generator().manual_seed(c)
    vals = torch.rand(*flow.shape[:3], c, generator=g).to(cuda, dtype)
    _check(softsplat_func(vals, flow), softsplat_torch(vals, flow), dtype)


def test_eisai_launch_counts(cuda):
    """Through the node's executor at x3 (three pairs, two timesteps each,
    batch 2), 2 RAFT iterations: no launch per reuse call, per infer call the
    K1 warps of ``warps_per_infer`` and 8 splats."""
    reuse_fn, infer_fn = eisai.make_pair_fns(eisai.init_params(0), device=cuda, iters=2)
    frames = torch.rand(4, 64, 96, 3, device=cuda)
    plan = plan_timestep(4, 3)
    _, by_count = loop._pair_groups(plan)
    infer_calls = sum(m * math.ceil(len(keys) / 2) for m, keys in by_count.items())
    warps, wide, splats = warp_kernel.launches, warp_kernel.wide_launches, softsplat_kernel.launches
    cache = reuse_fn(frames[:2], frames[1:3])
    torch.cuda.synchronize()
    assert (warp_kernel.launches, warp_kernel.wide_launches, softsplat_kernel.launches) == (warps, wide, splats)
    del cache
    out = loop.run_plan_pair_cached(frames, plan, reuse_fn, infer_fn, batch_size=2)
    torch.cuda.synchronize()
    assert eisai.warps_per_infer() == {"narrow": 2, "wide": 0}
    assert warp_kernel.launches - warps == 2 * infer_calls
    assert warp_kernel.wide_launches == wide
    assert softsplat_kernel.launches - splats == eisai.splats_per_infer() * infer_calls == 8 * infer_calls
    assert out.shape == (10, 64, 96, 3) and torch.isfinite(out).all()


@pytest.mark.parametrize("fastmode", [True, False])
@pytest.mark.parametrize("rescued", [False, True])
def test_rife40_launch_counts(cuda, fastmode, rescued):
    """One forward of arch 4.0 on ``[2, 64, 128, 3]``; block 1's head scaled
    by 1000 takes the restart with doubled scales."""
    params = rife.init_params(0, "4.0")
    if rescued:
        params = {k: v * 1000 if k.startswith("block1.lastconv") else v for k, v in params.items()}
    fn = rife.make_model_fn(params, "4.0", fastmode=fastmode, device=cuda)
    f0, f1 = torch.rand(2, 2, 64, 128, 3, device=cuda)
    warps, wide = warp_kernel.launches, warp_kernel.wide_launches
    out = fn(f0, f1, torch.full((2,), 0.5, device=cuda))
    torch.cuda.synchronize()
    want = rife.warps_per_forward("4.0", fastmode, rescued=rescued)
    assert {"narrow": warp_kernel.launches - warps, "wide": warp_kernel.wide_launches - wide} == want
    assert want["narrow"] == (5 if rescued else 4) and want["wide"] == (0 if fastmode else 4)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stmfnet_splat_shape(cuda, dtype):
    g = torch.Generator().manual_seed(7)
    vals = torch.rand(2, 1152, 1920, 4, generator=g).to(cuda, dtype)
    flow = torch.from_numpy(warp_cases.smooth_flow(2, 1152, 1920, 8.0)).to(cuda, dtype)
    _check(softsplat_func(vals, flow), softsplat_torch(vals, flow), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stmfnet_and_flavr_launch_counts(cuda, dtype):
    """Five frames through the window executor at batch 1 (two calls):
    STMFNet makes the warps of ``warps_per_forward`` and one splat per call,
    FLAVR none."""
    frames = torch.rand(5, 64, 96, 3, device=cuda)
    plan = plan_window4(5)
    before = (warp_kernel.launches, warp_kernel.wide_launches, softsplat_kernel.launches)
    out = loop.run_plan_window4(frames, plan, stmfnet.make_model_fn(stmfnet.init_params(0), dtype, cuda), batch_size=1)
    torch.cuda.synchronize()
    per = stmfnet.warps_per_forward(dtype)
    got = (warp_kernel.launches - before[0], warp_kernel.wide_launches - before[1], softsplat_kernel.launches - before[2])
    assert got == (2 * per["narrow"], 2 * per["wide"], 2 * stmfnet.splats_per_forward())
    assert per == {"narrow": 6, "wide": 4}
    assert out.shape == (7, 64, 96, 3) and torch.isfinite(out).all()
    before = (warp_kernel.launches, warp_kernel.wide_launches, softsplat_kernel.launches)
    out = loop.run_plan_window4(frames, plan, flavr.make_model_fn(flavr.init_params(0), dtype, cuda), batch_size=1)
    torch.cuda.synchronize()
    assert (warp_kernel.launches, warp_kernel.wide_launches, softsplat_kernel.launches) == before
    assert out.shape == (7, 64, 96, 3) and torch.isfinite(out).all()


@pytest.mark.parametrize("shape", [(4, 544, 960, 3), (4, 384, 512, 3)])
def test_xvfi_cfr_splat_shape(cuda, shape):
    g = torch.Generator().manual_seed(9)
    vals = torch.rand(shape, generator=g).to(cuda)
    flow = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], 8.0)).to(cuda)
    _check(softsplat_func(vals, flow), softsplat_torch(vals, flow), torch.float32)


@pytest.mark.parametrize("ckpt", list(xvfi.CKPT_CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xvfi_launch_counts(cuda, ckpt, dtype):
    reuse, infer = xvfi.make_pair_fns(xvfi.init_params(ckpt, 0), ckpt, dtype, cuda)
    f0, f1 = torch.rand(2, 2, 64, 96, 3, device=cuda)
    before = (warp_kernel.launches, warp_kernel.wide_launches, softsplat_kernel.launches)
    cache = reuse(f0, f1)
    torch.cuda.synchronize()
    per = xvfi.warps_per_reuse(ckpt, dtype)
    got = (warp_kernel.launches - before[0], warp_kernel.wide_launches - before[1], softsplat_kernel.launches - before[2])
    assert got == (per["narrow"], per["wide"], 0)
    before = (warp_kernel.launches, warp_kernel.wide_launches, softsplat_kernel.launches)
    out = infer(f0, f1, cache, torch.full((2,), 0.5, device=cuda))
    torch.cuda.synchronize()
    per = xvfi.warps_per_infer(dtype)
    got = (warp_kernel.launches - before[0], warp_kernel.wide_launches - before[1], softsplat_kernel.launches - before[2])
    assert got == (per["narrow"], per["wide"], xvfi.splats_per_infer())
    assert out.shape == (2, 64, 96, 3) and torch.isfinite(out).all()


# ---- the splat's backward kernel ------------------------------------------------

BACKWARD_CASES = {c["name"]: c for c in CASES + warp_cases.splat_backward_cases(1, 256, 512)}


def _within(got, ref, tol, dtype):
    """``got`` within ``tol`` of ``ref``, plus one ulp of ``ref`` for
    bf16/f16."""
    g, r = got.float(), ref.float()
    if dtype in MANTISSA_BITS:
        _, exp = torch.frexp(r.abs())
        tol = tol + torch.ldexp(torch.ones_like(r), exp - 1 - MANTISSA_BITS[dtype])
    err = (g - r).abs()
    assert bool((err <= tol).all()), err.max().item()


def _check_backward(vals, flow, grad_out=None, seed=0, in_grad=True):
    """The backward kernel on NHWC ``vals`` and ``flow`` and an f32 output
    gradient (uniform in [-1, 1] from ``seed`` unless given) against its
    plain version, and against a second launch, bit for bit."""
    if grad_out is None:
        g = torch.Generator().manual_seed(seed)
        grad_out = (torch.rand(vals.shape, generator=g) * 2 - 1).to(vals.device)
    args = (vals.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2), grad_out.permute(0, 3, 1, 2), in_grad)
    before = softsplat_kernel.backward_launches
    gi, gf = softsplat_kernel.softsplat_bilinear_backward(*args)
    again = softsplat_kernel.softsplat_bilinear_backward(*args)
    assert softsplat_kernel.backward_launches == before + 2
    ri, rf = softsplat_backward_torch(vals, flow, grad_out)
    contributions, _ = softsplat_backward_torch(vals.float(), flow.float(), grad_out.abs())
    torch.cuda.synchronize()
    assert (gi is None) != in_grad
    if in_grad:
        assert gi.dtype == vals.dtype and gi.shape == args[0].shape and torch.equal(gi, again[0])
        _within(gi.permute(0, 2, 3, 1), ri, 4 * 2.0**-23 * contributions, vals.dtype)
    assert gf.dtype == flow.dtype and gf.shape == args[1].shape and torch.equal(gf, again[1])
    _within(gf.permute(0, 2, 3, 1), rf, 1e-5 * rf.float().abs().max().item() + 1e-6, flow.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(BACKWARD_CASES))
def test_backward_matches_plain(cuda, name, dtype):
    case = BACKWARD_CASES[name]
    _check_backward(torch.from_numpy(case["vals"]).to(cuda, dtype), torch.from_numpy(case["flow"]).to(cuda))


def test_backward_f16(cuda):
    case = BACKWARD_CASES["splat_bwd_c5"]
    _check_backward(torch.from_numpy(case["vals"]).to(cuda, torch.float16), torch.from_numpy(case["flow"]).to(cuda, torch.float16))


@pytest.mark.parametrize("name", ["smooth_amp8_c4", "splat_bwd_c65", "splat_bwd_c2", "splat_bwd_c6", "splat_bwd_c66"])
def test_backward_without_the_input_gradient(cuda, name):
    case = BACKWARD_CASES[name]
    vals, flow = torch.from_numpy(case["vals"]).to(cuda), torch.from_numpy(case["flow"]).to(cuda)
    _check_backward(vals, flow, in_grad=False)
    grad_out = torch.rand(vals.shape, device=cuda)
    args = (vals.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2), grad_out.permute(0, 3, 1, 2))
    both = softsplat_kernel.softsplat_bilinear_backward(*args)
    alone = softsplat_kernel.softsplat_bilinear_backward(*args, in_grad=False)
    assert alone[0] is None and torch.equal(alone[1], both[1])


@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 6, 7, 8, 65, 66, 193, 258, 514])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_widths(cuda, c, dtype):
    g = torch.Generator().manual_seed(c)
    h, w = (64, 114) if c > 100 else (256, 512)
    vals = torch.rand(2, h, w, c, generator=g).to(cuda, dtype)
    flow = torch.from_numpy(warp_cases.smooth_flow(2, h, w, 6.0, scale=40.0)).to(cuda) + torch.randn(2, h, w, 2, generator=g).to(cuda)
    _check_backward(vals, flow, seed=c)


@pytest.mark.parametrize("c", [4, 7, 65, 66])
@pytest.mark.parametrize("layout", ["nchw_planes", "odd_channel_slice", "channel_slice_8_bytes", "expanded_grad_out"])
def test_backward_layouts(cuda, c, layout):
    g = torch.Generator().manual_seed(c)
    vals = torch.rand(2, 128, 256, c, generator=g).to(cuda)
    flow = torch.from_numpy(warp_cases.smooth_flow(2, 128, 256, 6.0, scale=40.0)).to(cuda)
    grad_out = (torch.rand(vals.shape, generator=g) * 2 - 1).to(cuda)
    if layout == "nchw_planes":
        vals = vals.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        grad_out = grad_out.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    elif layout in ("odd_channel_slice", "channel_slice_8_bytes"):
        # the slice starts 4 (8) bytes past a 16-byte boundary: element (2-channel) vectors at most
        skip = 1 if layout == "odd_channel_slice" else 2
        wider = torch.zeros(2, 128, 256, c + skip, device=cuda)
        wider[..., skip:] = vals
        vals = wider[..., skip:]
    else:
        grad_out = grad_out[:1, :1, :1].expand(vals.shape)
    _check_backward(vals, flow, grad_out=grad_out)


def test_backward_rejects_what_it_does_not_take(cuda):
    vals = torch.rand(1, 3, 8, 8, device=cuda)
    flow = torch.zeros(1, 2, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="grad_out"):
        softsplat_kernel.softsplat_bilinear_backward(vals, flow, vals.bfloat16())
    with pytest.raises(ValueError, match="grad_out"):
        softsplat_kernel.softsplat_bilinear_backward(vals, flow, vals[:, :2])
    with pytest.raises(ValueError, match="CUDA"):
        softsplat_kernel.softsplat_bilinear_backward(vals, flow.cpu(), vals)


def test_m2m_training_step_launches(cuda, monkeypatch):
    """One M2M training step on the card: the forward launches K1 4 times,
    the wide kernel 16 and the splat once, the backward the warp's backward
    kernel once per warp (20: each warp's flow needs a gradient) and the
    splat's once; no CUDA splat or warp that needs a gradient reaches a
    twin."""
    from comfyui_frame_interpolation_tpu_torch import parallel
    # ops.softsplat and ops.warp are also functions' names in ops/
    softsplat_mod = importlib.import_module("comfyui_frame_interpolation_tpu_torch.ops.softsplat")
    warp_mod = importlib.import_module("comfyui_frame_interpolation_tpu_torch.ops.warp")

    def refuse(real):
        def call(x, flow, *args):
            assert not (x.is_cuda and (x.requires_grad or flow.requires_grad)), "a CUDA op that needs a gradient reached a twin"
            return real(x, flow, *args)

        return call

    monkeypatch.setattr(softsplat_mod, "softsplat_torch", refuse(softsplat_mod.softsplat_torch))
    monkeypatch.setattr(warp_mod, "warp_torch", refuse(warp_mod.warp_torch))
    net = m2m.M2M_PWC()
    net.load_state_dict(m2m.init_params(0), strict=True)
    net = net.to(cuda, memory_format=torch.channels_last)
    step = parallel.make_train_step(m2m.apply, torch.optim.Adam(net.parameters(), lr=1e-4), parallel.make_mesh(1), net)
    f0, f1, target = torch.rand(3, 2, 64, 64, 3, device=cuda)
    counters = ("launches", "wide_launches", "backward_launches")
    before = [getattr(warp_kernel, k) for k in counters] + [softsplat_kernel.launches, softsplat_kernel.backward_launches]
    loss = step(f0, f1, torch.tensor([0.5, 0.25], device=cuda), target)
    torch.cuda.synchronize()
    after = [getattr(warp_kernel, k) for k in counters] + [softsplat_kernel.launches, softsplat_kernel.backward_launches]
    assert [a - b for a, b in zip(after, before)] == [4, 16, 20, 1, 1]
    assert torch.isfinite(loss) and all(torch.isfinite(p.grad).all() for p in net.parameters())


@pytest.mark.parametrize("name", ["gmfss", "eisai", "gmfss_union", "xvfi", "stmfnet", "ifrnet", "amt",
                                  "film", "ifunet", "atm", "cain", "flavr", "sepconv", "momo"])
def test_family_training_step_launches(cuda, name, monkeypatch):
    """One training step of each family that ``chip_smoke.py`` phases 55-61
    and 64-70 train, at b2 x 64x64 (STMFNet and CAIN 128x128) f32 on the card: exactly
    ``chip_smoke.FAMILY_STEP_LAUNCHES[name]`` launches of K1, the wide
    kernel, K2 and both backward kernels, no CUDA splat or warp that needs a
    gradient reaching a twin, and a finite loss and gradients."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    softsplat_mod = importlib.import_module("comfyui_frame_interpolation_tpu_torch.ops.softsplat")
    warp_mod = importlib.import_module("comfyui_frame_interpolation_tpu_torch.ops.warp")

    def refuse(real):
        def call(x, flow, *args):
            assert not (x.is_cuda and (x.requires_grad or flow.requires_grad)), "a CUDA op that needs a gradient reached a twin"
            return real(x, flow, *args)

        return call

    monkeypatch.setattr(softsplat_mod, "softsplat_torch", refuse(softsplat_mod.softsplat_torch))
    monkeypatch.setattr(warp_mod, "warp_torch", refuse(warp_mod.warp_torch))
    net, step = chip_smoke.family_trainer(name, cuda)
    batch = chip_smoke.family_batch(name, 2, chip_smoke.FAMILY_CHECK_HW.get(name, (64, 64)), 0, cuda)
    before = chip_smoke.kernel_counts()
    loss = step(*batch)
    torch.cuda.synchronize()
    after = chip_smoke.kernel_counts()
    assert {k: after[k] - before[k] for k in after} == chip_smoke.FAMILY_STEP_LAUNCHES[name]
    assert torch.isfinite(loss) and all(torch.isfinite(p.grad).all() for p in net.parameters() if p.grad is not None)


# ---- a band of sources (the space axis of parallel/) ------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("spans", [((0, 64), (64, 73)), ((0, 64), (64, 64), (128, 9))])
def test_k2_band_partials_sum_to_the_whole_frame(cuda, spans, dtype):
    """K2's band partials (``row0``, ``out_rows``) against the twin's band
    (f32 partials within ``F32_ATOL``), their f32 sum against the
    whole-frame kernel (within ``F32_ATOL``) and, cast once, against
    ``softsplat_func`` (one ulp), on flow that crosses the bands' edges and
    leaves the frame; ``row0=0`` at full height is the whole-frame call's
    shape and values."""
    g = torch.Generator().manual_seed(len(spans))
    vals = torch.rand(2, 137, 93, 4, generator=g).to(cuda, dtype)
    flow = ((torch.rand(2, 137, 93, 2, generator=g) * 2 - 1) * 30).to(cuda)
    planes, fplanes = vals.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)
    whole = softsplat_kernel.softsplat_bilinear(planes, fplanes)
    same = softsplat_kernel.softsplat_bilinear(planes, fplanes, row0=0, out_rows=137)
    _check(same, whole, torch.float32)
    total = torch.zeros_like(whole)
    before = softsplat_kernel.launches
    for row0, rows in spans:
        vb, fb = planes[:, :, row0 : row0 + rows], fplanes[:, :, row0 : row0 + rows]
        part = softsplat_kernel.softsplat_bilinear(vb, fb, row0=row0, out_rows=137)
        assert part.shape == (2, 4, 137, 93) and part.dtype == torch.float32
        twin = softsplat_torch(vals[:, row0 : row0 + rows].float(), flow[:, row0 : row0 + rows], row0=row0, out_rows=137)
        _check(part.permute(0, 2, 3, 1), twin, torch.float32)
        total += part
    assert softsplat_kernel.launches - before == len(spans)
    _check(total, whole, torch.float32)
    _check(total.permute(0, 2, 3, 1).to(dtype), softsplat_func(vals, flow), dtype)


@pytest.mark.parametrize("c, dtype", [(65, torch.bfloat16), (193, torch.bfloat16), (514, torch.float32)])
@pytest.mark.parametrize("spans", [((0, 64), (64, 73)), ((0, 64), (64, 64), (128, 9))])
def test_k2_band_partials_at_the_wide_widths(cuda, spans, c, dtype):
    """K2's wide-channel route (C > 4: the bands of GMFSS's and EISAI's
    splats on the space axis) with a band of sources: each partial against
    the twin's band, their f32 sum against the whole-frame kernel, as
    :func:`test_k2_band_partials_sum_to_the_whole_frame` holds C = 4."""
    g = torch.Generator().manual_seed(c + len(spans))
    vals = torch.rand(1, 137, 93, c, generator=g).to(cuda, dtype)
    flow = ((torch.rand(1, 137, 93, 2, generator=g) * 2 - 1) * 30).to(cuda)
    planes, fplanes = vals.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)
    whole = softsplat_kernel.softsplat_bilinear(planes, fplanes)
    total = torch.zeros_like(whole)
    for row0, rows in spans:
        vb, fb = planes[:, :, row0 : row0 + rows], fplanes[:, :, row0 : row0 + rows]
        part = softsplat_kernel.softsplat_bilinear(vb, fb, row0=row0, out_rows=137)
        assert part.shape == (1, c, 137, 93) and part.dtype == torch.float32
        twin = softsplat_torch(vals[:, row0 : row0 + rows].float(), flow[:, row0 : row0 + rows], row0=row0, out_rows=137)
        _check(part.permute(0, 2, 3, 1), twin, torch.float32)
        total += part
    _check(total, whole, torch.float32)


def test_m2m_on_a_space_split_matches_one_device(cuda):
    """M2M's pair functions on a ``(1, 2)`` mesh of replicas of the card
    (two bands of 64 rows) against one device, f32 with TF32 off and cuDNN's
    deterministic algorithms (as ``chip_smoke.py`` phase 75 holds it),
    within 1e-4: K1 8, the wide kernel 32 per reuse and K2 2 per infer,
    twice the one device's 4, 16 and 1. The frames are a smooth pattern
    moved a few pixels a frame: on uniform noise M2M's normaliser gets
    small enough at some pixels for f32 rounding alone to move them by
    ~1e-4."""
    from comfyui_frame_interpolation_tpu_torch import parallel

    params = m2m.init_params(0)
    gy, gx = torch.meshgrid(torch.arange(128.0, device=cuda), torch.arange(192.0, device=cuda), indexing="ij")
    frames = torch.stack([
        torch.stack([0.5 + 0.4 * torch.sin((gx - 3 * i) / (9.0 + c) + (gy + 2 * i) / (13.0 - c)) for c in range(3)], -1)
        for i in range(3)
    ])
    plan = plan_timestep(3, 2)  # 2 pairs, one timestep each: one reuse and one infer at batch 2
    one = m2m.make_pair_fns(params, device=cuda)
    sharded = parallel.make_sharded_pair_fns(lambda d: one, parallel.make_mesh(2, devices=[cuda] * 2))
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        ref = loop.run_plan_pair_cached(frames, plan, *one, batch_size=2)
        before = warp_kernel.launches, warp_kernel.wide_launches, softsplat_kernel.launches
        out = loop.run_plan_pair_cached(frames, plan, *sharded, batch_size=2)
        torch.cuda.synchronize()
        after = warp_kernel.launches, warp_kernel.wide_launches, softsplat_kernel.launches
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.deterministic = det
    assert tuple(a - b for a, b in zip(after, before)) == (8, 32, 2)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("c, dtype", [(4, torch.float32), (4, torch.bfloat16), (65, torch.float32), (66, torch.float32)])
@pytest.mark.parametrize("spans", [((0, 64), (64, 73)), ((0, 64), (64, 64), (128, 9))])
def test_backward_band_is_the_whole_frames_rows(cuda, spans, c, dtype):
    """The splat's backward on a band of sources (``row0``, ``out_rows``)
    reads the whole frame's output gradient at its sources' global corners:
    each band's ``grad_in`` is the whole-frame launch's rows bit for bit,
    and so is its ``grad_flow`` where the band's launch sums a source's
    slots with the whole frame's lanes (always for C <= 8, a thread per
    source; on the spread route for C > 8 where both launches fill 2048
    pairs a block: not the 9-row band, whose 6 sources a block take 8 lanes
    a corner against the whole frame's 2, an order that is right within the
    plain version's tolerance); each band within ``_check_backward``'s
    tolerances of the plain version's band; ``row0 = 0`` at the whole
    height is the default call."""
    g = torch.Generator().manual_seed(c + len(spans))
    vals = torch.rand(2, 137, 93, c, generator=g).to(cuda, dtype)
    flow = ((torch.rand(2, 137, 93, 2, generator=g) * 2 - 1) * 30).to(cuda)
    grad_out = (torch.rand(2, 137, 93, c, generator=g) * 2 - 1).to(cuda)
    planes, fplanes, gplanes = vals.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2), grad_out.permute(0, 3, 1, 2)
    whole_i, whole_f = softsplat_kernel.softsplat_bilinear_backward(planes, fplanes, gplanes)
    same_i, same_f = softsplat_kernel.softsplat_bilinear_backward(planes, fplanes, gplanes, True, 0, 137)
    contributions, _ = softsplat_backward_torch(vals.float(), flow, grad_out.abs())
    torch.cuda.synchronize()
    assert torch.equal(same_i, whole_i) and torch.equal(same_f, whole_f)
    for row0, rows in spans:
        vb, fb = planes[:, :, row0 : row0 + rows], fplanes[:, :, row0 : row0 + rows]
        gi, gf = softsplat_kernel.softsplat_bilinear_backward(vb, fb, gplanes, True, row0, 137)
        ri, rf = softsplat_backward_torch(vals[:, row0 : row0 + rows], flow[:, row0 : row0 + rows], grad_out, row0, 137)
        torch.cuda.synchronize()
        assert gi.shape == vb.shape and gf.shape == fb.shape
        assert torch.equal(gi, whole_i[:, :, row0 : row0 + rows])
        if c <= 8 or rows >= 64:
            assert torch.equal(gf, whole_f[:, :, row0 : row0 + rows])
        _within(gi.permute(0, 2, 3, 1), ri, 4 * 2.0**-23 * contributions[:, row0 : row0 + rows], dtype)
        _within(gf.permute(0, 2, 3, 1), rf, 1e-5 * rf.float().abs().max().item() + 1e-6, flow.dtype)
    with pytest.raises(ValueError, match="does not lie within"):
        softsplat_kernel.softsplat_bilinear_backward(planes[:, :, :64], fplanes[:, :, :64], gplanes, True, 100, 137)


@pytest.mark.parametrize("spans", [((0, 64), (64, 73)), ((0, 64), (64, 64), (128, 9))])
def test_band_partials_carry_the_gradient(cuda, spans):
    """``softsplat_partial`` with a gradient goes through ``SplatFunction``
    on the band (one K2 and one backward launch a band): the gradients of
    the partials' sum are the whole frame's splat's, the values' bit for
    bit (each band's backward reads the whole output gradient at its own
    sources), the flow's bit for bit where every band takes the whole
    frame's lanes (C = 65: bands of 64 rows or more, as
    :func:`test_backward_band_is_the_whole_frames_rows` says) and else
    within the plain version's tolerance."""
    g = torch.Generator().manual_seed(len(spans))
    vals = torch.rand(2, 137, 93, 65, generator=g).to(cuda).requires_grad_()
    flow = ((torch.rand(2, 137, 93, 2, generator=g) * 2 - 1) * 30).to(cuda).requires_grad_()
    grad_out = (torch.rand(2, 137, 93, 65, generator=g) * 2 - 1).to(cuda)
    ref = torch.autograd.grad(softsplat_func(vals, flow), (vals, flow), grad_out)
    before = softsplat_kernel.launches, softsplat_kernel.backward_launches
    total = sum(softsplat_partial(vals[:, a : a + n], flow[:, a : a + n], a, 137) for a, n in spans)
    got = torch.autograd.grad(total, (vals, flow), grad_out)
    torch.cuda.synchronize()
    assert (softsplat_kernel.launches - before[0], softsplat_kernel.backward_launches - before[1]) == (len(spans), len(spans))
    assert torch.equal(got[0], ref[0])
    if min(n for _, n in spans) >= 64:
        assert torch.equal(got[1], ref[1])
    else:
        _within(got[1], ref[1], 1e-5 * ref[1].abs().max().item() + 1e-6, torch.float32)
