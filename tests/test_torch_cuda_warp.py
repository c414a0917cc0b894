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
bf16 and f16 (among them a width for each vector width the kernel picks:
16, 8 and 4 bytes and one element), on NCHW-contiguous input (the
documented ``channels_last`` copy), on crops and channel slices whose
strides and base addresses narrow the vector, at FILM's level-0 feature warp
``[4, 1080, 1920, 64]`` bf16, and against K1 on the same tensor; a FILM
forward launches it 11 times and K1 5 times.

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
kernel ``warp_kernel.route`` names and through K1, bit for bit. Their bf16
feature pixels of C = 54, 36, 44, 20 start off 16 bytes, so the wide
kernel reads them in 4- and 8-byte vectors.

ATM's and XVFI's warps at their 1080p shapes, zeros mode, f32 and bf16 with
the flow in the same dtype (the f32 ones planes with f32 flow), each through
the routed kernel and through K1, bit for bit: ATM base batch 1 (padded to
1088x1920): the fused features ``[1, 136, 240, 384]`` (lite 224) and the
frames at 1/4, 1/2 and 1; the enhanced features' two halves as the model
gives them, channel slices of ``[1, 136, 240, 768]`` (pixel stride 768),
never made contiguous; XVFI Vimeo batch 2 (padded to 1088x1920): the
features ``[2, 544, 960, 64]``, the frames and the ones planes; X4K batch 2
(padded to 1536x2048): the features at 1/4 to 1/64. An ATM forward
launches the warps of ``atm.warps_per_forward`` (XVFI's counts are held in
``tests/test_torch_cuda_softsplat.py``).

The backward kernel (``warp_kernel.warp_bilinear_backward``) against its
plain version ``ops.warp.warp_backward_torch`` on every flow case, border
and zeros, f32, bf16 and f16 (flow in f32), on samples exactly on each bound
(the clamp's derivative 0.5), on the wide cases as ``channels_last`` views
(a channel slice among them) and with ``img_grad=False``; and on the cases
that its merges and channel padding could break (``warp_cases.backward_cases``
at 256x512: C = 1 to 40, ragged 68x92 and 137x261 frames, integer and
half-pixel constant offsets, rough and discontinuous flow, a pile of 256
samples on each tap), f32, bf16 and f16, each also without the image's
gradient (the flow's bit for bit the same); on NCHW planes,
``channels_last``, a channel slice with an odd start and an expanded
``grad_out`` (the vector widths each layout allows); what it returns
(an f32 image gradient as a view of the padded buffer, a bf16 one in the
image's layout, the flow's in the flow's). Tolerances: f32
within 1e-5 of each gradient's largest magnitude plus 1e-6 (the image's
gradient sums with f32 atomics, in an order that changes from run to run,
and so does the plain version's scatter; the flow's sums its channels in
another order); bf16/f16 within one ulp of the plain value plus that.
``WarpFunction`` through ``ops.warp.warp``: the forward kernel that
``route`` names and the backward kernel launched once each, the gradients
of both inputs (and of the flow alone) equal to the plain version's, an
expanded output gradient taken as it is; and one RIFE 4.7 training step
launches K1 4 times and the backward kernel 4 times.

Row bands (the ``space`` axis of ``parallel/``): K1 and the wide kernel
(C = 3-7 and 16-384, border and zeros, f32 and bf16) with ``row0`` bit for
bit the twin's band and the whole-frame call's rows, a band routed to the
wide kernel with and without a gradient launching it, the backward's bands
against the plain version and summed against the whole frame, and RIFE 4.7
on a ``(1, 2)`` mesh of replicas of the card against one device.
"""

import numpy as np
import pytest
import torch

import warp_cases
from comfyui_frame_interpolation_tpu_torch import parallel
from comfyui_frame_interpolation_tpu_torch.models import atm, film, rife
from comfyui_frame_interpolation_tpu_torch.ops.cuda import warp_kernel
from comfyui_frame_interpolation_tpu_torch.ops.warp import warp, warp_backward_torch, warp_torch

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("view", ["crop", "slice_even", "slice_odd"])
@pytest.mark.parametrize("c", [20, 36, 54, 64])
def test_wide_kernel_takes_strided_views_bitwise(cuda, c, view, dtype):
    # a crop: row and batch strides of the full frame; a channel slice from
    # channel 4 (8 bytes in bf16) or 1: the pixel stride and base address
    # narrow the vector width below what C alone allows
    g = torch.Generator().manual_seed(c)
    if view == "crop":
        img = torch.rand(2, 45, 81, c, generator=g).to(cuda, dtype)[:, 3:-2, 5:-4]
    else:
        full = torch.rand(2, 40, 72, c + 5, generator=g).to(cuda, dtype)
        img = full[..., 4 : 4 + c] if view == "slice_even" else full[..., 1 : 1 + c]
    flow = torch.from_numpy(warp_cases.smooth_flow(2, *img.shape[1:3], 4.0, 10.0)).to(cuda)
    for mode in ("border", "zeros"):
        got = warp(img, flow, mode, prefer_wide=True)
        torch.cuda.synchronize()
        assert torch.equal(got, warp_torch(img, flow, mode))


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


# ATM base / lite 1080p batch 1 and XVFI Vimeo / X4K 1080p batch 2, zeros
# mode: (NHWC shape, value dtype or None for the model's, the kernel route
# names); the ones planes are f32 in every model dtype
ATM_XVFI_WARPS = (
    ((1, 136, 240, 384), None, "wide"), ((1, 136, 240, 224), None, "wide"), ((1, 272, 480, 3), None, "tiled"),
    ((1, 544, 960, 3), None, "tiled"), ((1, 1088, 1920, 3), None, "tiled"),
    ((2, 544, 960, 64), None, "wide"), ((2, 1088, 1920, 3), None, "tiled"), ((2, 544, 960, 1), torch.float32, "tiled"),
    ((2, 1088, 1920, 1), torch.float32, "tiled"), ((2, 384, 512, 64), None, "wide"), ((2, 24, 32, 64), None, "wide"),
    ((2, 1536, 2048, 3), None, "tiled"),
)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,value_dtype,body", ATM_XVFI_WARPS)
def test_atm_xvfi_warps_zeros(cuda, shape, value_dtype, body, dtype):
    g = torch.Generator().manual_seed(sum(shape))
    vdt = value_dtype or dtype
    img = torch.rand(shape, generator=g).to(cuda, vdt)
    flow = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], amp=6.0)).to(cuda, dtype)
    planes = img.permute(0, 3, 1, 2)
    assert warp_kernel.route(planes.shape, planes.stride(), vdt) == body
    ref = warp_torch(img, flow, "zeros")
    routed = warp(img, flow, "zeros")
    k1 = warp_kernel.warp_bilinear(planes, flow.permute(0, 3, 1, 2), True).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    assert torch.equal(routed, ref) and torch.equal(k1, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("half", [0, 1])
def test_atm_enhanced_feature_halves_as_channel_slices(cuda, half, dtype):
    """``feat_enh[..., :384]`` and ``[..., 384:768]`` of ATM base at 1080p:
    views with pixel stride 768, the second starting 768 (f32) or 384 (bf16)
    bytes in; on the wide kernel, no copy."""
    g = torch.Generator().manual_seed(11 + half)
    feat = torch.rand(1, 136, 240, 768, generator=g).to(cuda, dtype)
    img = feat[..., 384 * half : 384 * (half + 1)]
    flow = torch.from_numpy(warp_cases.smooth_flow(1, 136, 240, amp=6.0)).to(cuda, dtype)
    planes = img.permute(0, 3, 1, 2)
    assert planes.stride() == (136 * 240 * 768, 1, 240 * 768, 768) and not img.is_contiguous()
    assert warp_kernel.route(planes.shape, planes.stride(), dtype) == "wide"
    ref = warp_torch(img, flow, "zeros")
    routed = warp(img, flow, "zeros")
    k1 = warp_kernel.warp_bilinear(planes, flow.permute(0, 3, 1, 2), True).permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    assert torch.equal(routed, ref) and torch.equal(k1, ref)


@pytest.mark.parametrize("variant,global_motion,ensemble", [
    ("base", True, False), ("base", False, False), ("lite", True, False), ("base", True, True),
])
def test_atm_forward_launches(cuda, variant, global_motion, ensemble):
    fn = atm.make_model_fn(atm.init_params(variant, 0), variant, global_motion, ensemble, torch.bfloat16, cuda)
    f0, f1 = torch.rand(2, 1, 128, 192, 3, device=cuda)
    before = (warp_kernel.launches, warp_kernel.wide_launches)
    out = fn(f0, f1)
    torch.cuda.synchronize()
    got = {"narrow": warp_kernel.launches - before[0], "wide": warp_kernel.wide_launches - before[1]}
    assert got == atm.warps_per_forward(variant, global_motion, ensemble, torch.bfloat16)
    assert out.shape == (1, 128, 192, 3) and torch.isfinite(out).all()


# ---- the backward kernel ---------------------------------------------------

MANTISSA_BITS = {torch.bfloat16: 8, torch.float16: 11}


def _ulp(r, dtype):
    """One ulp of each value of ``r`` in ``dtype`` (0 for f32)."""
    if dtype not in MANTISSA_BITS:
        return torch.zeros_like(r)
    _, exp = torch.frexp(r.abs())
    return torch.ldexp(torch.ones_like(r), exp - MANTISSA_BITS[dtype])


def _assert_grad_close(got, ref, dtype):
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    g, r = got.float(), ref.float()
    tol = 1e-5 * float(r.abs().max()) + 1e-6 + _ulp(r, dtype)
    assert bool(((g - r).abs() <= tol).all()), float((g - r).abs().max())


def _backward_vs_plain(img, flow, mode, seed=0):
    g = torch.Generator().manual_seed(seed)
    grad_out = (torch.rand(img.shape, generator=g) * 2 - 1).to(img.device, img.dtype)
    before = warp_kernel.backward_launches
    gi, gf = warp_kernel.warp_bilinear_backward(
        img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2), grad_out.permute(0, 3, 1, 2), mode == "zeros"
    )
    ri, rf = warp_backward_torch(img, flow, grad_out, mode)
    assert warp_kernel.backward_launches == before + 1
    _assert_grad_close(gi.permute(0, 2, 3, 1), ri, img.dtype)
    _assert_grad_close(gf.permute(0, 2, 3, 1), rf, flow.dtype)
    return gf.permute(0, 2, 3, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name,mode", CASE_MODES)
def test_backward_kernel_matches_plain(cuda, name, mode, dtype):
    case = next(c for c in CASES if c["name"] == name)
    img = torch.from_numpy(case["img"]).to(cuda, dtype)
    flow = torch.from_numpy(case["flow"]).to(cuda)
    gf = _backward_vs_plain(img, flow, mode)
    if mode == "zeros":
        assert bool((gf[~torch.isfinite(flow).all(-1)] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_backward_kernel_on_exact_bounds(cuda, mode, dtype):
    img = torch.rand(2, 64, 96, 7, generator=torch.Generator().manual_seed(1)).to(cuda, dtype)
    flow = torch.from_numpy(warp_cases.bound_flow(2, 64, 96)).to(cuda)
    _backward_vs_plain(img, flow, mode, seed=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,mode", WIDE_MODES)
def test_backward_kernel_on_wide_views(cuda, name, mode, dtype):
    img, flow = _wide_case(name, cuda, dtype)
    _backward_vs_plain(img, flow, mode, seed=2)


def test_backward_kernel_without_the_image_gradient(cuda):
    case = CASES[1]
    img = torch.from_numpy(case["img"]).to(cuda)
    flow = torch.from_numpy(case["flow"]).to(cuda)
    grad_out = torch.rand(img.shape, device=cuda) - 0.5
    args = img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2), grad_out.permute(0, 3, 1, 2)
    gi, gf = warp_kernel.warp_bilinear_backward(*args, img_grad=False)
    _, ref = warp_kernel.warp_bilinear_backward(*args)
    torch.cuda.synchronize()
    assert gi is None and torch.equal(gf, ref)


BACKWARD = warp_cases.backward_cases(0, 256, 512)
BACKWARD_MODES = [(c["name"], m) for c in BACKWARD for m in c["modes"]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name,mode", BACKWARD_MODES)
def test_backward_kernel_on_backward_cases(cuda, name, mode, dtype):
    case = next(c for c in BACKWARD if c["name"] == name)
    img = torch.from_numpy(case["img"]).to(cuda, dtype)
    flow = torch.from_numpy(case["flow"]).to(cuda)
    gf = _backward_vs_plain(img, flow, mode, seed=4)
    grad_out = (torch.rand(img.shape, generator=torch.Generator().manual_seed(4)) * 2 - 1).to(cuda, dtype)
    gi, gf_alone = warp_kernel.warp_bilinear_backward(
        img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2), grad_out.permute(0, 3, 1, 2), mode == "zeros", img_grad=False
    )
    torch.cuda.synchronize()
    assert gi is None and torch.equal(gf_alone.permute(0, 2, 3, 1), gf)


def _layout(kind, img):
    """NHWC ``img`` (``[N, H, W, C]``) in the layout ``kind``, as an NHWC view."""
    n, h, w, c = img.shape
    if kind == "nchw_planes":
        return img.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    if kind == "channel_slice_odd":
        base = torch.zeros(n, h, w, c + 1, dtype=img.dtype, device=img.device)
        base[..., 1:] = img
        return base[..., 1:]
    return img  # channels_last


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["border", "zeros"])
@pytest.mark.parametrize("c", [3, 4, 7, 8])
@pytest.mark.parametrize("layout", ["channels_last", "nchw_planes", "channel_slice_odd", "expanded_grad_out"])
def test_backward_kernel_layouts(cuda, layout, c, mode, dtype):
    gen = torch.Generator().manual_seed(c)
    img = torch.rand(2, 64, 96, c, generator=gen).to(cuda, dtype)
    flow = torch.from_numpy(warp_cases.smooth_flow(2, 64, 96, 4.0, 16.0)).to(cuda)
    grad_out = None
    if layout == "expanded_grad_out":
        grad_out = (torch.rand(1, 1, 1, c, generator=gen) * 2 - 1).to(cuda, dtype).expand(img.shape)
    else:
        img = _layout(layout, img)
    planes = img.permute(0, 3, 1, 2)
    g = grad_out if grad_out is not None else _layout(layout, (torch.rand(img.shape, generator=gen) * 2 - 1).to(cuda, dtype))
    gi, gf = warp_kernel.warp_bilinear_backward(planes, flow.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2), mode == "zeros")
    ri, rf = warp_backward_torch(img, flow, g, mode)
    _assert_grad_close(gi.permute(0, 2, 3, 1), ri, dtype)
    _assert_grad_close(gf.permute(0, 2, 3, 1), rf, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("c", [3, 7, 8])
def test_backward_returns(cuda, c, dtype):
    img = torch.rand(2, 40, 72, c, device=cuda).to(dtype)
    flow = torch.from_numpy(warp_cases.smooth_flow(2, 40, 72, 3.0)).to(cuda, torch.bfloat16)
    planes, fplanes = img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2)
    gi, gf = warp_kernel.warp_bilinear_backward(planes, fplanes, torch.ones_like(planes))
    torch.cuda.synchronize()
    assert gi.shape == planes.shape and gi.dtype == dtype and gf.shape == fplanes.shape and gf.dtype == torch.bfloat16
    cp = warp_kernel.padded_channels(c)
    if dtype == torch.float32:
        # a view of the zeroed f32 buffer [N, H, W, Cp]: no pass after the kernel
        assert gi.stride() == (40 * 72 * cp, 1, 72 * cp, cp)
    else:
        # the one cast, into the image's layout
        assert gi.stride() == planes.stride()
    assert gf.stride() == fplanes.stride()


@pytest.mark.parametrize("shape,prefer_wide,body", [((2, 64, 96, 7), False, "tiled"), ((2, 64, 96, 64), True, "wide")])
@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_warp_function_through_warp(cuda, shape, prefer_wide, body, mode):
    gen = torch.Generator().manual_seed(3)
    img = torch.rand(shape, generator=gen).to(cuda)
    flow = torch.from_numpy(warp_cases.smooth_flow(*shape[:3], 4.0, 10.0)).to(cuda)
    grad_out = (torch.rand(shape, generator=gen) - 0.5).to(cuda)
    counts = lambda: (warp_kernel.launches, warp_kernel.wide_launches, warp_kernel.backward_launches)  # noqa: E731
    before = counts()
    x, f = img.clone().requires_grad_(), flow.clone().requires_grad_()
    gi, gf = torch.autograd.grad(warp(x, f, mode, prefer_wide=prefer_wide), (x, f), grad_out)
    assert tuple(a - b for a, b in zip(counts(), before)) == ((1, 0, 1) if body == "tiled" else (0, 1, 1))
    ri, rf = warp_backward_torch(img, flow, grad_out, mode)
    _assert_grad_close(gi, ri, torch.float32)
    _assert_grad_close(gf, rf, torch.float32)
    # the flow alone needs a gradient (the frames of a RIFE forward); an
    # expanded output gradient (out.sum()) is taken with its zero strides
    f = flow.clone().requires_grad_()
    warp(img, f, mode, prefer_wide=prefer_wide).sum().backward()
    _, rf1 = warp_backward_torch(img, flow, torch.ones_like(img), mode)
    _assert_grad_close(f.grad, rf1, torch.float32)


def test_warp_without_grad_skips_warp_function(cuda):
    img = torch.rand(1, 32, 64, 7, device=cuda, requires_grad=True)
    flow = torch.zeros(1, 32, 64, 2, device=cuda)
    before = warp_kernel.backward_launches
    with torch.no_grad():
        out = warp(img, flow)
    assert out.grad_fn is None and warp_kernel.backward_launches == before


def test_rife_train_step_launches_four_k1_and_four_backward(cuda):
    net = rife.IFNet("4.7")
    net.load_state_dict(rife.init_params(0, "4.7"))
    net = net.to(cuda, memory_format=torch.channels_last)
    mesh = parallel.make_mesh(1)
    step = parallel.make_train_step(
        lambda n, a, b, t: rife.apply(n, a, b, t, rife.default_scale_list("4.7")),
        torch.optim.Adam(net.parameters(), lr=1e-4), mesh, net,
    )
    f = torch.rand(2, 64, 128, 3, device=cuda)
    before = warp_kernel.launches, warp_kernel.wide_launches, warp_kernel.backward_launches
    loss = step(f, f.flip(2), torch.full((2,), 0.5, device=cuda), (f + f.flip(2)) / 2)
    torch.cuda.synchronize()
    after = warp_kernel.launches, warp_kernel.wide_launches, warp_kernel.backward_launches
    assert tuple(a - b for a, b in zip(after, before)) == (4, 0, 4)
    assert bool(torch.isfinite(loss))


# ---- a row band (the space axis of parallel/) -------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["border", "zeros"])
@pytest.mark.parametrize("c", [3, 5, 7])
def test_k1_band_matches_the_twins_band(cuda, c, mode, dtype):
    g = torch.Generator().manual_seed(c)
    img = torch.rand(2, 137, 261, c, generator=g).to(cuda, dtype)
    flow = ((torch.rand(2, 137, 261, 2, generator=g) * 2 - 1) * 9).to(cuda)
    planes = img.permute(0, 3, 1, 2)
    whole = warp_kernel.warp_bilinear(planes, flow.permute(0, 3, 1, 2), mode == "zeros")
    assert torch.equal(warp_kernel.warp_bilinear(planes, flow.permute(0, 3, 1, 2), mode == "zeros", row0=0), whole)
    for row0, rows in ((0, 64), (64, 73), (136, 1)):
        fb = flow[:, row0 : row0 + rows]
        got = warp_kernel.warp_bilinear(planes, fb.permute(0, 3, 1, 2), mode == "zeros", row0=row0).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        assert torch.equal(got, warp_torch(img, fb, mode, row0=row0))
        assert torch.equal(got, whole.permute(0, 2, 3, 1)[:, row0 : row0 + rows])
        assert torch.equal(warp(img, fb, mode, row0=row0), got)


@pytest.mark.parametrize("mode", ["border", "zeros"])
@pytest.mark.parametrize("img_grad", [True, False])
def test_backward_band_matches_plain_and_the_bands_sum_to_the_whole(cuda, mode, img_grad):
    g = torch.Generator().manual_seed(3)
    img = torch.rand(2, 137, 261, 7, generator=g).to(cuda)
    flow = ((torch.rand(2, 137, 261, 2, generator=g) * 2 - 1) * 9).to(cuda)
    grad = (torch.rand(2, 137, 261, 7, generator=g) * 2 - 1).to(cuda)
    planes = img.permute(0, 3, 1, 2)
    gi_whole, _ = warp_kernel.warp_bilinear_backward(planes, flow.permute(0, 3, 1, 2), grad.permute(0, 3, 1, 2), mode == "zeros")
    total = torch.zeros_like(img)
    for row0, rows in ((0, 64), (64, 73)):
        fb, gb = flow[:, row0 : row0 + rows], grad[:, row0 : row0 + rows]
        gi, gf = warp_kernel.warp_bilinear_backward(
            planes, fb.permute(0, 3, 1, 2), gb.permute(0, 3, 1, 2), mode == "zeros", img_grad, row0=row0
        )
        ri, rf = warp_backward_torch(img, fb, gb, mode, row0=row0)
        _assert_grad_close(gf.permute(0, 2, 3, 1), rf, torch.float32)
        if img_grad:
            _assert_grad_close(gi.permute(0, 2, 3, 1), ri, torch.float32)
            total += gi.permute(0, 2, 3, 1)
        else:
            assert gi is None
    if img_grad:
        _assert_grad_close(total, gi_whole.permute(0, 2, 3, 1), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["border", "zeros"])
@pytest.mark.parametrize("c", [16, 32, 48, 96, 384])
def test_wide_band_matches_the_twins_band(cuda, c, mode, dtype):
    """The wide kernel's row band (M2M's feature widths, C = 32-384, and C =
    16) is bit for bit the twin's band and the whole-frame call's rows, and
    ``row0=0`` at full height is the whole-frame call."""
    g = torch.Generator().manual_seed(c)
    img = torch.rand(2, 137, 93, c, generator=g).to(cuda, dtype)
    flow = ((torch.rand(2, 137, 93, 2, generator=g) * 2 - 1) * 9).to(cuda)
    planes = img.permute(0, 3, 1, 2)
    assert warp_kernel.route(planes.shape, planes.stride(), dtype) == "wide"
    whole = warp_kernel.warp_bilinear_wide(planes, flow.permute(0, 3, 1, 2), mode == "zeros")
    assert torch.equal(warp_kernel.warp_bilinear_wide(planes, flow.permute(0, 3, 1, 2), mode == "zeros", row0=0), whole)
    before = warp_kernel.wide_launches
    for row0, rows in ((0, 64), (64, 73), (136, 1)):
        fb = flow[:, row0 : row0 + rows]
        got = warp_kernel.warp_bilinear_wide(planes, fb.permute(0, 3, 1, 2), mode == "zeros", row0=row0).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        assert torch.equal(got, warp_torch(img, fb, mode, row0=row0))
        assert torch.equal(got, whole.permute(0, 2, 3, 1)[:, row0 : row0 + rows])
        assert torch.equal(warp(img, fb, mode, row0=row0), got)
    assert warp_kernel.wide_launches - before == 6


def test_a_band_that_routes_to_the_wide_kernel_raises(cuda):
    """A band that routes to the wide kernel used to raise; the kernel now
    takes the band, with and without a gradient, and launches itself (never
    K1 or the twin in its place)."""
    g = torch.Generator().manual_seed(16)
    img = torch.rand(1, 128, 64, 16, generator=g).to(cuda, torch.bfloat16)
    flow = ((torch.rand(1, 64, 64, 2, generator=g) * 2 - 1) * 9).to(cuda)
    twin = warp_torch(img, flow, "border", row0=64)
    before = warp_kernel.launches, warp_kernel.wide_launches
    plain = warp(img, flow, row0=64)
    with_grad = warp(img.clone().requires_grad_(), flow, row0=64)
    torch.cuda.synchronize()
    assert (warp_kernel.launches - before[0], warp_kernel.wide_launches - before[1]) == (0, 2)
    assert torch.equal(plain, twin) and torch.equal(with_grad.detach(), twin)


def test_rife_on_a_space_split_matches_one_device(cuda):
    """f32 with TF32 off, as chip_smoke.py phase 73 holds it (with TF32 the
    two runs' convolutions round their inputs to TF32 and the frames drift
    apart by ~2e-4)."""
    params = rife.init_params(0, "4.7")
    f0, f1 = torch.rand(2, 128, 192, 3, device=cuda), torch.rand(2, 128, 192, 3, device=cuda)
    t = torch.full((2,), 0.5, device=cuda)
    one = rife.make_model_fn(params, "4.7", device=cuda)
    mesh = parallel.make_mesh(2, devices=[cuda] * 2)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = warp_kernel.launches
        out = parallel.make_sharded_model_fn(lambda d: one, mesh)(f0, f1, t)
        torch.cuda.synchronize()
        assert warp_kernel.launches - before == 8  # K1 4 a forward, on each of two bands
        torch.testing.assert_close(out, one(f0, f1, t), rtol=0, atol=1e-4)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
