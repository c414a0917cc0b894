"""The port's plain warp twin against the JAX package's ``warp_xla`` and Pallas
kernel, on the CPU.

* ``warp_torch`` vs ``warp_xla``: f32, border and zeros, on the flow cases of
  ``tests/warp_cases.py`` at 32x128, atol 2e-6 on values in [0, 1] (XLA:CPU
  may contract the bilinear sum into FMAs: about one f32 ulp). Pixels whose
  flow is non-finite are masked: ``warp_xla`` propagates NaN there, the twin
  and the kernels give 0 in zeros mode.
* one bf16 case vs ``warp_pallas_tiered`` run in interpret mode, patched as
  ``tests/test_pallas_interpret.py`` does, to one bf16 ulp.
* ``grid_sample`` vs JAX for both ``align_corners`` and padding modes.
* CPU tensors never reach either CUDA kernel's path, with or without
  ``prefer_wide``; ``warp(prefer_wide=True)`` equals the twin on the CPU.
* the wide cases (FILM's feature warps, ``warp_cases.wide_cases`` at 16x32:
  C = 32 to 960, C = 46, a channel slice off 16 bytes, extreme and non-finite
  flow) vs ``warp_xla``, as the narrow cases are.
* ``warp_kernel.route``, the rule that picks the kernel on the card:
  RIFE's, M2M's and FILM's shapes, layouts and dtypes, the 32-byte threshold
  and 16-byte pixels, ``prefer_wide`` and layouts whose channels are not
  contiguous; and the kernels the three models' own tensors are routed to,
  counted per forward on the CPU with the rule applied to each warp's input.
"""

import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import warp_cases
from comfyui_frame_interpolation_tpu.ops.pallas import warp_kernel as jwk
from comfyui_frame_interpolation_tpu.ops.warp import grid_sample as jax_grid_sample
from comfyui_frame_interpolation_tpu.ops.warp import warp_xla
from comfyui_frame_interpolation_tpu_torch.ops.warp import grid_sample, warp, warp_torch
from comfyui_frame_interpolation_tpu_torch.ops.cuda import build as cuda_build
from comfyui_frame_interpolation_tpu_torch.ops.cuda import warp_kernel as cuda_wk
from comfyui_frame_interpolation_tpu_torch.ops.warp import warp as port_warp
from comfyui_frame_interpolation_tpu_torch.models import film, m2m, rife
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

F32_ATOL = 2e-6
BF16_ULP = 2.0**-8

CASES = warp_cases.warp_cases(0, 32, 128)
CASE_MODES = [(c["name"], m) for c in CASES for m in c["modes"]]
WIDE = warp_cases.wide_cases(1, 16, 32)
WIDE_MODES = [(c["name"], m) for c in WIDE for m in c["modes"]]


def _case(name):
    return next(c for c in CASES if c["name"] == name)


@pytest.mark.parametrize("name,mode", CASE_MODES)
def test_twin_matches_warp_xla(name, mode):
    case = _case(name)
    ref = np.asarray(warp_xla(jnp.asarray(case["img"]), jnp.asarray(case["flow"]), mode))
    got = warp_torch(torch.from_numpy(case["img"]), torch.from_numpy(case["flow"]), mode).numpy()
    finite = np.isfinite(case["flow"]).all(-1)
    np.testing.assert_allclose(got[finite], ref[finite], atol=F32_ATOL, rtol=0)
    if mode == "zeros":
        assert np.all(got[~finite] == 0.0)


@pytest.mark.parametrize("name,mode", WIDE_MODES)
def test_wide_cases_twin_matches_warp_xla(name, mode):
    case = next(c for c in WIDE if c["name"] == name)
    img = case["img"][..., case["offset"] :]
    ref = np.asarray(warp_xla(jnp.asarray(img), jnp.asarray(case["flow"]), mode))
    timg = torch.from_numpy(case["img"])[..., case["offset"] :]
    got = warp(timg, torch.from_numpy(case["flow"]), mode, prefer_wide=True).numpy()
    finite = np.isfinite(case["flow"]).all(-1)
    np.testing.assert_allclose(got[finite], ref[finite], atol=F32_ATOL, rtol=0)
    if mode == "zeros":
        assert np.all(got[~finite] == 0.0)


def test_twin_matches_pallas_interpret_bf16():
    case = _case("moderate_amp20")
    img = jnp.asarray(case["img"][:1, :, :, :3], jnp.bfloat16)
    flow = jnp.asarray(case["flow"][:1])
    orig = pl.pallas_call

    def interpret(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    with mock.patch.dict("os.environ", {"CFI_WARP_MXU": "0"}), mock.patch.object(jwk.pl, "pallas_call", interpret):
        ref = np.asarray(jwk.warp_pallas_tiered(img, flow, zeros=False).astype(jnp.float32))
    got = warp_torch(torch.tensor(np.asarray(img.astype(jnp.float32))).to(torch.bfloat16), torch.tensor(np.asarray(flow)))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=BF16_ULP, rtol=0)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("mode", ["zeros", "border"])
def test_grid_sample_matches_jax(align_corners, mode):
    rng = np.random.default_rng(3)
    img = rng.random((2, 24, 40, 3), dtype=np.float32)
    grid = (rng.random((2, 16, 20, 2), dtype=np.float32) * 2.4 - 1.2).astype(np.float32)
    ref = np.asarray(jax_grid_sample(jnp.asarray(img), jnp.asarray(grid), mode, align_corners))
    got = grid_sample(torch.from_numpy(img), torch.from_numpy(grid), mode, align_corners).numpy()
    np.testing.assert_allclose(got, ref, atol=F32_ATOL, rtol=0)


def test_cpu_tensors_never_take_the_cuda_path():
    def forbidden(*a, **k):
        raise AssertionError("CUDA-only path taken for CPU tensors")

    case = _case("wide_c40")
    img, flow = torch.from_numpy(case["img"]), torch.from_numpy(case["flow"])
    before = cuda_wk.launches, cuda_wk.wide_launches
    with mock.patch.object(cuda_wk, "warp_bilinear", forbidden), mock.patch.object(
        cuda_wk, "warp_bilinear_wide", forbidden
    ), mock.patch.object(cuda_build, "load_library", forbidden):
        for mode in ("border", "zeros"):
            for prefer_wide in (False, True):
                torch.testing.assert_close(
                    warp(img, flow, mode, prefer_wide=prefer_wide), warp_torch(img, flow, mode), rtol=0, atol=0
                )
    assert (cuda_wk.launches, cuda_wk.wide_launches) == before == (0, 0)


def test_dispatch_rejects_other_devices_and_the_kernel_rejects_cpu():
    img = torch.zeros(1, 4, 4, 3)
    flow = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError):
        warp(img.to("meta"), flow.to("meta"))
    with pytest.raises(ValueError):
        warp(img, flow, "reflection")
    with pytest.raises(ValueError):
        warp(img.to("meta"), flow.to("meta"), prefer_wide=True)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_wk.warp_bilinear(img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_wk.warp_bilinear_wide(img.permute(0, 3, 1, 2), flow.permute(0, 3, 1, 2))
    assert cuda_wk.launches == cuda_wk.wide_launches == 0


def test_twin_nan_flow_border_propagates_nan():
    img = torch.rand(1, 8, 16, 2)
    flow = torch.zeros(1, 8, 16, 2)
    flow[0, 3, 5, 0] = float("nan")
    out = warp_torch(img, flow)
    assert torch.isnan(out[0, 3, 5]).all()
    assert torch.isfinite(out.flatten(1, 2)[:, torch.arange(128) != 3 * 16 + 5]).all()


CL, NCHW = torch.channels_last, torch.contiguous_format
ROUTES = [
    # RIFE: the 7-channel image+feature warps and the last 3-channel one
    ((16, 7, 1088, 1920), CL, torch.bfloat16, False, "tiled"),
    ((16, 7, 1088, 1920), CL, torch.float32, False, "tiled"),  # 28 bytes a pixel
    ((16, 3, 1088, 1920), CL, torch.bfloat16, False, "tiled"),
    # M2M: flow-net and encoder-decoder features, then the image warps
    ((4, 32, 272, 480), CL, torch.float32, False, "wide"),
    ((4, 32, 272, 480), CL, torch.bfloat16, False, "wide"),
    ((2, 48, 544, 960), CL, torch.bfloat16, False, "wide"),
    ((2, 96, 272, 480), CL, torch.bfloat16, False, "wide"),
    ((2, 192, 136, 240), CL, torch.bfloat16, False, "wide"),
    ((2, 384, 68, 120), CL, torch.bfloat16, False, "wide"),
    ((8, 3, 1088, 1920), CL, torch.bfloat16, False, "tiled"),
    # FILM: features forced wide, images by the rule
    ((4, 64, 1080, 1920), CL, torch.bfloat16, True, "wide"),
    ((4, 960, 135, 240), CL, torch.float32, True, "wide"),
    ((4, 3, 1080, 1920), CL, torch.bfloat16, False, "tiled"),
    # the 32-byte threshold in each dtype, and pixels of one 16-byte vector
    ((1, 15, 8, 8), CL, torch.bfloat16, False, "tiled"),
    ((1, 16, 8, 8), CL, torch.bfloat16, False, "wide"),
    ((1, 16, 8, 8), CL, torch.float16, False, "wide"),
    ((1, 7, 8, 8), CL, torch.float32, False, "tiled"),
    ((1, 8, 8, 8), CL, torch.float32, False, "wide"),
    ((1, 8, 8, 8), CL, torch.bfloat16, False, "wide"),
    ((1, 4, 8, 8), CL, torch.float32, False, "wide"),
    ((1, 4, 8, 8), CL, torch.bfloat16, False, "tiled"),
    ((1, 12, 8, 8), CL, torch.bfloat16, False, "tiled"),
    # channels that are not contiguous: K1, unless forced wide
    ((16, 7, 64, 64), NCHW, torch.bfloat16, False, "tiled"),
    ((2, 64, 16, 16), NCHW, torch.bfloat16, False, "tiled"),
    ((2, 64, 16, 16), NCHW, torch.bfloat16, True, "wide"),
    ((2, 1, 16, 16), NCHW, torch.float32, False, "tiled"),  # one channel: no stride to speak of
    # M2M's fp32 node: 12-byte image pixels, 1536-byte feature pixels
    ((8, 3, 1088, 1920), CL, torch.float32, False, "tiled"),
    ((2, 384, 68, 120), CL, torch.float32, False, "wide"),
]


@pytest.mark.parametrize("shape,fmt,dtype,prefer_wide,body", ROUTES)
def test_route_picks_the_kernel_body(shape, fmt, dtype, prefer_wide, body):
    planes = torch.empty(shape, dtype=dtype, device="meta", memory_format=fmt)
    assert cuda_wk.route(planes.shape, planes.stride(), dtype, prefer_wide) == body


def test_route_of_views():
    nhwc = torch.empty(2, 16, 32, 10, device="meta")
    # an NHWC tensor's permuted view, and a channel slice of it: channel stride 1
    assert cuda_wk.route(nhwc.permute(0, 3, 1, 2).shape, nhwc.permute(0, 3, 1, 2).stride(), torch.float32) == "wide"
    sl = nhwc[..., 2:5].permute(0, 3, 1, 2)
    assert cuda_wk.route(sl.shape, sl.stride(), torch.float32) == "tiled"
    # a view whose channels are rows of the storage, even 96 bytes of them
    for c in (3, 24):
        rows = torch.empty(2, 16, c, 32, device="meta").permute(0, 2, 1, 3)
        assert cuda_wk.route(rows.shape, rows.stride(), torch.float32) == "tiled"


def test_m2m_warp_split_follows_the_route():
    assert len(m2m.WARP_CHANNELS_PER_REUSE) == m2m.WARPS_PER_REUSE == 20
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        assert m2m.warps_per_reuse(dtype) == {"narrow": 4, "wide": 16}


def _routed_bodies(module, fn, *args):
    """The kernel bodies ``route`` picks for every warp of ``fn(*args)``,
    applied to the tensors the model really passes (run on the CPU)."""
    bodies = []

    def spy(img, flow, padding_mode="border", prefer_wide=False):
        planes = img.permute(0, 3, 1, 2)
        bodies.append(cuda_wk.route(planes.shape, planes.stride(), planes.dtype, prefer_wide))
        return port_warp(img, flow, padding_mode, prefer_wide)

    with mock.patch.object(module, "warp", spy):
        fn(*args)
    return {b: bodies.count(b) for b in sorted(set(bodies))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model", ["rife", "m2m", "film"])
def test_each_model_warp_takes_the_kernel_its_launch_counts_expect(model, dtype):
    rng = np.random.default_rng(5)
    if model == "rife":
        fn = rife.make_model_fn(rife.init_params(0, "4.7"), "4.7", dtype=dtype, device="cpu")
        f = torch.from_numpy(rng.random((2, 64, 128, 3), dtype=np.float32))
        expect = {"tiled": 4}
    elif model == "m2m":
        fn = m2m.make_model_fn(m2m.init_params(0), dtype=dtype, device="cpu")
        f = torch.from_numpy(rng.random((1, 64, 128, 3), dtype=np.float32))
        split = m2m.warps_per_reuse(dtype)
        expect = {"tiled": split["narrow"], "wide": split["wide"]}
    else:
        fn = film.make_model_fn(film.init_params(0), dtype=dtype, device="cpu")
        f = torch.from_numpy(rng.random((1, 64, 64, 3), dtype=np.float32))
        expect = {"tiled": film.WARPS_PER_CALL["narrow"], "wide": film.WARPS_PER_CALL["wide"]}
    module = {"rife": rife, "m2m": m2m, "film": film}[model]
    t = torch.full((f.shape[0],), 0.5)
    assert _routed_bodies(module, fn, f, f.flip(2), t) == expect


def test_ptxas_summary_reads_registers_and_spills():
    log = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_126warp_bilinear_tiled_kernelI6__halffLb1ELi7EEEvPKT_' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers, 4160 bytes smem, 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116softsplat_kernelIffEEvPKT_' for 'sm_90a'\n"
        "    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 255 registers, 400 bytes cmem[0]\n"
    )
    assert cuda_build.ptxas_summary(log) == [
        "warp_bilinear_tiled_kernel: 40 regs 4160 B smem no spills",
        "softsplat_kernel: 255 regs 0 B smem 8/4 B spilled",
    ]


def test_library_path_follows_the_source_and_its_headers(tmp_path):
    """A kernel library is named by its source and the headers beside it
    (``csrc/scatter.cuh``, which the warp and splat sources include), so an
    edit of either builds a new library."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = cuda_build.library_path("k", str(tmp_path))
    assert cuda_build.library_path("k", str(tmp_path)) == first
    assert os.path.basename(first).startswith("libk-") and first.endswith(".so")
    (tmp_path / "h.cuh").write_text("// two\n")
    second = cuda_build.library_path("k", str(tmp_path))
    assert second != first
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert cuda_build.library_path("k", str(tmp_path)) not in (first, second)
