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
"""

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
