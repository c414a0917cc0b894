"""The hand-written Hopper warp kernels against their plain twin, on the card.

Marked ``cuda``; every test skips when ``torch.cuda.is_available()`` is
false (decided inside the fixture, never at import). Run on a machine with
an H100::

    python -m pytest tests/test_torch_cuda_warp.py -m cuda -q

Tolerances: f32 atol 2e-6 on values in [0, 1]; bf16/f16 one ulp (2**-8 /
2**-11). The kernel uses non-contracting ``_rn`` arithmetic in the twin's
order, so on the card it is expected to match bit for bit; the tolerances are
the stated bound.

The wide-channel kernel (``warp_bilinear_wide``) is held to the twin bit for
bit (``torch.equal``) on the wide cases of ``tests/warp_cases.py`` in f32,
bf16 and f16, on NCHW-contiguous input (the documented ``channels_last``
copy), at FILM's level-0 feature warp ``[4, 1080, 1920, 64]`` bf16, and
against K1 on the same tensor; a FILM forward launches it 11 times and K1 5
times.

K1 (the tiled kernel) is held to the twin bit for bit on every flow case
(including a frame half of whose tiles read taps from far across the frame,
a 68x92 frame, M2M's widths), in f32, bf16 and f16, border and zeros, on
NHWC views, on a channel slice, on NCHW planes and through a flow slice, and
at RIFE's ``[16, 1088, 1920, 7]`` bf16; ``warp`` sends each layout to the
kernel ``warp_kernel.route`` names.

GMFSS Fortuna's warps: K1 on 2-channel flows (the metric net's
forward/backward consistency) in zeros mode, f32 and bf16, on smooth and
rough flow, bit for bit; and GMFlow's scale-1 feature warp ``[1, 136, 240,
128]`` bf16 in zeros mode (1080p batch 1), routed to the wide kernel and bit
for bit.

STMFNet's backwarps, zeros mode, f32 and bf16: the PWC feature warps at
1080p (both directions, ``[2, 288, 480, C]`` to ``[2, 36, 60, C]``) at the
widths a forward warps (C = 32, 64, 96, 128) and with the ones channel
appended (C = 33, 65, 97, 129: unaligned pixels, the wide kernel's scalar
path), and the f32 ones plane (C = 1), each through the routed kernel and
through K1, bit for bit.

IFRNet's, IFUnet's and AMT's warps at their 1080p shapes (padded to
1088x1920), border mode, f32 and bf16 with the flow in the same dtype:
IFRNet S batch 4's features (C = 54, 36, 24 at 1/8 to 1/2) and frames,
IFUnet batch 2's frames and context warp (C = 32 at 1/4), AMT-S batch 2's
features (C = 44, 32, 20) and frames over its 3 flows; each through the
kernel ``warp_kernel.route`` names and through K1, bit for bit. Most of the
feature pixels start off 16 bytes (bf16 C = 54, 36, 44, 20), so the wide
kernel's scalar path carries them.
"""

import numpy as np
import pytest
import torch

import warp_cases
from comfyui_frame_interpolation_tpu_torch.models import film, rife
from comfyui_frame_interpolation_tpu_torch.ops.cuda import warp_kernel
from comfyui_frame_interpolation_tpu_torch.ops.warp import warp, warp_torch

pytestmark = pytest.mark.cuda

ATOL = {torch.float32: 2e-6, torch.bfloat16: 2.0**-8, torch.float16: 2.0**-11}
CASES = warp_cases.warp_cases(0, 256, 512)
CASE_MODES = [(c["name"], m) for c in CASES for m in c["modes"]]
WIDE = warp_cases.wide_cases(0, 128, 256)
WIDE_MODES = [(c["name"], m) for c in WIDE for m in c["modes"]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(kernel_out, plain_out, dtype):
    torch.cuda.synchronize()
    err = (kernel_out.float() - plain_out.float()).abs().max().item()
    assert err <= ATOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name,mode", CASE_MODES)
def test_kernel_matches_twin(cuda, name, mode, dtype):
    case = next(c for c in CASES if c["name"] == name)
    img = torch.from_numpy(case["img"]).to(cuda, dtype)
    flow = torch.from_numpy(case["flow"]).to(cuda)
    _check(warp(img, flow, mode), warp_torch(img, flow, mode), dtype)


@pytest.mark.parametrize("flow_dtype", [torch.bfloat16, torch.float16])
def test_low_precision_flow(cuda, flow_dtype):
    case = CASES[1]
    img = torch.from_numpy(case["img"]).to(cuda, torch.bfloat16)
    flow = torch.from_numpy(case["flow"]).to(cuda, flow_dtype)
    _check(warp(img, flow), warp_torch(img, flow), torch.bfloat16)


def test_layouts_agree_and_launches_are_counted(cuda):
    case = CASES[1]
    img = torch.from_numpy(case["img"]).to(cuda, torch.bfloat16)
    flow = torch.from_numpy(case["flow"]).to(cuda)
    before = warp_kernel.launches
    nhwc = warp(img, flow)
    planes = warp_kernel.warp_bilinear(img.permute(0, 3, 1, 2).contiguous(), flow.permute(0, 3, 1, 2).contiguous())
    assert warp_kernel.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(planes.permute(0, 2, 3, 1), nhwc)


def test_main_path_shape(cuda):
    g = torch.Generator().manual_seed(0)
    img = torch.rand(16, 1088, 1920, 7, generator=g).to(cuda, torch.bfloat16)
    flow = torch.from_numpy(warp_cases.smooth_flow(16, 1088, 1920, 6.0)).to(cuda)
    before = warp_kernel.launches
    got, ref = warp(img, flow), warp_torch(img, flow)
    _check(got, ref, torch.bfloat16)
    assert torch.equal(got, ref) and warp_kernel.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name,mode", CASE_MODES)
def test_k1_matches_twin_bitwise(cuda, name, mode, dtype):
    case = next(c for c in CASES if c["name"] == name)
    img = torch.from_numpy(case["img"]).to(cuda, dtype)
    flow = torch.from_numpy(case["flow"]).to(cuda)
    got = warp_kernel.warp_bilinear(img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2), mode == "zeros")
    ref = warp_torch(img, flow, mode)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("layout", ["channel_slice", "nchw_planes", "flow_slice"])
@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_k1_takes_other_layouts_bitwise(cuda, layout, mode):
    case = next(c for c in CASES if c["name"] == "box_overflow_half")
    full = torch.from_numpy(case["img"]).to(cuda, torch.bfloat16)
    flow = torch.from_numpy(case["flow"]).to(cuda)
    if layout == "channel_slice":  # channel stride 1, pixel stride 7
        img, planes = full[..., 1:4], full[..., 1:4].permute(0, 3, 1, 2)
    elif layout == "nchw_planes":  # channel stride H*W
        img = full
        planes = full.permute(0, 3, 1, 2).contiguous()
    else:  # a flow read through a channel slice of a wider tensor
        img, planes = full, full.permute(0, 3, 1, 2)
        flow = torch.cat([flow[..., 1:], flow, flow[..., :1]], -1)[..., 1:3]
    got = warp_kernel.warp_bilinear(planes, flow.permute(0, 3, 1, 2), mode == "zeros")
    ref = warp_torch(img, flow, mode)
    torch.cuda.synchronize()
    assert torch.equal(got.permute(0, 2, 3, 1), ref)


def test_warp_takes_the_routed_body(cuda):
    img = torch.rand(1, 16, 32, 7, device=cuda, dtype=torch.bfloat16)
    flow = torch.zeros(1, 16, 32, 2, device=cuda)
    counts = lambda: (warp_kernel.launches, warp_kernel.wide_launches)  # noqa: E731
    before = counts()
    warp(img, flow)  # NHWC, 14 B a pixel: K1
    warp(img.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), flow)  # NCHW planes: K1
    warp(torch.rand(1, 16, 32, 48, device=cuda, dtype=torch.bfloat16), flow, "zeros")  # 96 B a pixel: wide
    warp(img, flow, prefer_wide=True)  # forced wide
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (2, 2)


def test_kernel_rejects_what_it_does_not_take(cuda):
    img = torch.rand(1, 3, 8, 8, device=cuda)
    flow = torch.zeros(1, 2, 8, 8, device=cuda)
    with pytest.raises(TypeError):
        warp_kernel.warp_bilinear(img.double(), flow)
    with pytest.raises(ValueError):
        warp_kernel.warp_bilinear(img, flow[:, :1])
    with pytest.raises(NotImplementedError):
        warp_kernel.warp_bilinear(img.requires_grad_(), flow)


def test_rife_forward_launches_four_warps(cuda):
    fn = rife.make_model_fn(rife.init_params(0, "4.7"), "4.7", device=cuda)
    f = torch.rand(2, 64, 128, 3, device=cuda)
    before = warp_kernel.launches
    out = fn(f, f.flip(2), torch.full((2,), 0.5, device=cuda))
    torch.cuda.synchronize()
    assert warp_kernel.launches - before == 4
    assert out.shape == (2, 64, 128, 3) and torch.isfinite(out).all()


def _wide_case(name, device, dtype):
    case = next(c for c in WIDE if c["name"] == name)
    img = torch.from_numpy(case["img"]).to(device, dtype)[..., case["offset"] :]
    return img, torch.from_numpy(case["flow"]).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name,mode", WIDE_MODES)
def test_wide_kernel_matches_twin_bitwise(cuda, name, mode, dtype):
    img, flow = _wide_case(name, cuda, dtype)
    before = warp_kernel.wide_launches
    got = warp(img, flow, mode, prefer_wide=True)
    ref = warp_torch(img, flow, mode)
    torch.cuda.synchronize()
    assert warp_kernel.wide_launches == before + 1
    assert got.dtype == dtype and torch.equal(got, ref)


def test_wide_kernel_takes_nchw_input_through_one_copy(cuda):
    img, flow = _wide_case("wide_c192", cuda, torch.bfloat16)
    planes = img.permute(0, 3, 1, 2).contiguous()  # NCHW: channel stride H*W
    out = warp_kernel.warp_bilinear_wide(planes, flow.permute(0, 3, 1, 2).contiguous())
    torch.cuda.synchronize()
    assert out.stride(1) == 1
    assert torch.equal(out.permute(0, 2, 3, 1), warp_torch(img, flow))


def test_wide_kernel_equals_k1_at_film_level0_shape(cuda):
    g = torch.Generator().manual_seed(0)
    img = torch.rand(4, 1080, 1920, 64, generator=g).to(cuda, torch.bfloat16)
    flow = torch.from_numpy(warp_cases.smooth_flow(4, 1080, 1920, 6.0)).to(cuda)
    wide = warp(img, flow, prefer_wide=True)
    k1 = warp_kernel.warp_bilinear(img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    assert torch.equal(wide, k1)
    del k1
    assert torch.equal(wide, warp_torch(img, flow))


def test_wide_kernel_rejects_what_it_does_not_take(cuda):
    img = torch.rand(1, 64, 8, 8, device=cuda)
    flow = torch.zeros(1, 2, 8, 8, device=cuda)
    with pytest.raises(TypeError):
        warp_kernel.warp_bilinear_wide(img.double(), flow)
    with pytest.raises(ValueError):
        warp_kernel.warp_bilinear_wide(img, flow[:, :1])
    with pytest.raises(NotImplementedError):
        warp_kernel.warp_bilinear_wide(img.requires_grad_(), flow)


def test_film_forward_launches_eleven_wide_and_five_k1_warps(cuda):
    fn = film.make_model_fn(film.init_params(0), device=cuda)
    f = torch.rand(2, 128, 128, 3, device=cuda)
    before = warp_kernel.wide_launches, warp_kernel.launches
    out = fn(f, f.flip(2), torch.full((2,), 0.5, device=cuda))
    torch.cuda.synchronize()
    assert (warp_kernel.wide_launches - before[0], warp_kernel.launches - before[1]) == (
        film.WARPS_PER_CALL["wide"], film.WARPS_PER_CALL["narrow"]
    ) == (11, 5)
    assert out.shape == (2, 128, 128, 3) and torch.isfinite(out).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("amp", [6.0, 40.0])
def test_k1_on_two_channel_flows_zeros(cuda, dtype, amp):
    rng = np.random.default_rng(int(amp))
    img = torch.from_numpy(rng.standard_normal((2, 256, 512, 2)).astype(np.float32) * 8).to(cuda, dtype)
    if amp > 10:  # rough: a random flow of that scale
        flow = torch.from_numpy((rng.standard_normal((2, 256, 512, 2)) * amp).astype(np.float32)).to(cuda)
    else:
        flow = torch.from_numpy(warp_cases.smooth_flow(2, 256, 512, amp)).to(cuda)
    planes = img.permute(0, 3, 1, 2)
    assert warp_kernel.route(planes.shape, planes.stride(), dtype) == "tiled"
    before = warp_kernel.launches
    got = warp(img, flow, "zeros")
    ref = warp_torch(img, flow, "zeros")
    torch.cuda.synchronize()
    assert warp_kernel.launches == before + 1
    assert torch.equal(got, ref)


def test_wide_kernel_at_gmflow_feature_warp(cuda):
    g = torch.Generator().manual_seed(1)
    img = torch.rand(1, 136, 240, 128, generator=g).to(cuda, torch.bfloat16)
    flow = torch.from_numpy(warp_cases.smooth_flow(1, 136, 240, 6.0)).to(cuda, torch.bfloat16)
    planes = img.permute(0, 3, 1, 2)
    assert warp_kernel.route(planes.shape, planes.stride(), img.dtype) == "wide"
    before = warp_kernel.wide_launches
    got = warp(img, flow, "zeros")
    torch.cuda.synchronize()
    assert warp_kernel.wide_launches == before + 1
    assert torch.equal(got, warp_torch(img, flow, "zeros"))


# STMFNet 1080p batch 1 (padded to 1152x1920), both directions: the PWC
# feature levels 2 to 5
STMFNET_LEVELS = ((2, 288, 480, 32), (2, 144, 240, 64), (2, 72, 120, 96), (2, 36, 60, 128))


@pytest.mark.parametrize("extra", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", STMFNET_LEVELS)
def test_stmfnet_feature_warps_zeros(cuda, shape, dtype, extra):
    g = torch.Generator().manual_seed(shape[3] + extra)
    img = torch.rand(*shape[:3], shape[3] + extra, generator=g).to(cuda, dtype)
    flow = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=6.0)).to(cuda, dtype)
    planes = img.permute(0, 3, 1, 2)
    assert warp_kernel.route(planes.shape, planes.stride(), dtype) == "wide"
    ref = warp_torch(img, flow, "zeros")
    routed = warp(img, flow, "zeros")
    k1 = warp_kernel.warp_bilinear(planes, flow.permute(0, 3, 1, 2), True).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    assert torch.equal(routed, ref) and torch.equal(k1, ref)


@pytest.mark.parametrize("flow_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 288, 480, 1), (2, 1152, 1920, 1)])
def test_stmfnet_ones_plane_on_k1(cuda, shape, flow_dtype):
    ones = torch.ones(shape, device=cuda)
    flow = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=6.0)).to(cuda, flow_dtype)
    planes = ones.permute(0, 3, 1, 2)
    assert warp_kernel.route(planes.shape, planes.stride(), ones.dtype) == "tiled"
    got = warp(ones, flow, "zeros")
    torch.cuda.synchronize()
    assert torch.equal(got, warp_torch(ones, flow, "zeros"))


# IFRNet S 1080p batch 4, IFUnet and AMT-S 1080p batch 2 (padded to
# 1088x1920): (NHWC shape, the kernel route names)
SLICE8_WARPS = (
    ((4, 136, 240, 54), "wide"), ((4, 272, 480, 36), "wide"), ((4, 544, 960, 24), "wide"), ((4, 1088, 1920, 3), "tiled"),
    ((2, 1088, 1920, 3), "tiled"), ((2, 272, 480, 32), "wide"),
    ((2, 136, 240, 44), "wide"), ((2, 272, 480, 32), "wide"), ((2, 544, 960, 20), "wide"), ((6, 1088, 1920, 3), "tiled"),
)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,body", SLICE8_WARPS)
def test_ifrnet_ifunet_amt_warps_border(cuda, shape, body, dtype):
    g = torch.Generator().manual_seed(sum(shape))
    img = torch.rand(shape, generator=g).to(cuda, dtype)
    flow = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=6.0)).to(cuda, dtype)
    planes = img.permute(0, 3, 1, 2)
    assert warp_kernel.route(planes.shape, planes.stride(), dtype) == body
    ref = warp_torch(img, flow, "border")
    routed = warp(img, flow, "border")
    k1 = warp_kernel.warp_bilinear(planes, flow.permute(0, 3, 1, 2), False).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    assert torch.equal(routed, ref) and torch.equal(k1, ref)
