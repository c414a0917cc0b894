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
"""

import math

import pytest
import torch

import warp_cases
from comfyui_frame_interpolation_tpu_torch.core import loop
from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_timestep
from comfyui_frame_interpolation_tpu_torch.models import m2m
from comfyui_frame_interpolation_tpu_torch.ops.cuda import softsplat_kernel, warp_kernel
from comfyui_frame_interpolation_tpu_torch.ops.softsplat import softsplat_func, softsplat_torch

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
