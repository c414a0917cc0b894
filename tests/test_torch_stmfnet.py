"""The port's STMFNet against the JAX package's, on the CPU, with the same weights
(the port's numpy ``init_params`` carried across by ``nest_state_dict``) and
the same numpy inputs.

* ``state_dict`` keys and shapes equal the ``stmfnet.pth`` manifest (1000
  tensors, ``tests/fixtures/ckpt_manifests.json``); seeding is deterministic;
  batch norms start at the identity.
* ``correlation_func`` within 1e-6; ``adacof_func`` within 1e-5 of the
  magnitude on negative fractional offsets, offsets that clamp at every
  edge, dilation 2 and an output built in many bands; bf16 within bf16
  rounding of the f32 result.
* ``_backwarp_masked`` at an odd width (13x19, C = 5) within 1e-6, the mask
  equal; ``_upsampler_8tap`` within 1e-6.
* Every stage on the JAX stages' own inputs (the golden's demo frames,
  reflect-padded to 128x128, batch norms' running statistics perturbed so
  that they act): the PWC flows both ways, the feature extractor, each of
  the three scale streams, the flow splat, the GridNet and the UNet3d, each
  within ``TOL`` = 2e-5 x (1 + the largest magnitude).
* ``make_model_fn`` end to end in fp32 (68x120, padded to 128x128 inside)
  within 1e-4; bf16 against JAX fp32 >= 40 dB.
* ``warps_per_forward`` and ``splats_per_forward`` equal what a forward makes.
* The JAX golden (``tests/fixtures/torch_port_stmfnet_golden.npz``:
  ``demo_frames/seq/0-3.png`` every eighth pixel, 68x120, weights from the
  seed) is regenerated with JAX and must be unchanged; the port matches it at
  >= 40 dB.

The JAX stages are one jitted function with the weights as an argument (one
compile serves both weight sets). Run ``python tests/test_torch_stmfnet.py``
to rewrite the fixture.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.models import common as jc
from comfyui_frame_interpolation_tpu.models import stmfnet as js
from comfyui_frame_interpolation_tpu.ops.adacof import adacof_func as jax_adacof
from comfyui_frame_interpolation_tpu.ops.correlation import correlation_func as jax_correlation
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch.models import stmfnet as ps
from comfyui_frame_interpolation_tpu_torch.ops import adacof as padacof
from comfyui_frame_interpolation_tpu_torch.ops.correlation import correlation_func
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "torch_port_stmfnet_golden.npz")
GOLDEN_SEED = 4321
TOL = 2e-5


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def _close(got, ref, what, tol=TOL):
    ref = np.asarray(ref)
    got = np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= tol * (1.0 + np.abs(ref).max()), (what, err)


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


def _perturbed(seed):
    """``init_params(seed)`` with each batch norm's running statistics drawn
    away from the identity (mean in +-0.2, variance in 0.8-1.2), as the JAX
    parity test does, so that the port's batch norms act."""
    sd = ps.init_params(seed)
    rng = np.random.default_rng(seed + 100)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            sd[k] = torch.from_numpy(rng.uniform(-0.2, 0.2, v.shape).astype(np.float32))
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.8, 1.2, v.shape).astype(np.float32))
    return sd


@functools.lru_cache(maxsize=None)
def _params(which):
    sd = _perturbed(0) if which == "perturbed" else ps.init_params(GOLDEN_SEED)
    return sd, to_jax_tree(nest_state_dict(sd))


@functools.lru_cache(maxsize=None)
def _net(which):
    return ps._load(_params(which)[0], torch.float32, "cpu")


# ---- a. layout and weights -------------------------------------------------------


def test_state_dict_equals_the_manifest():
    with open(os.path.join(ROOT, "tests", "fixtures", "ckpt_manifests.json")) as f:
        want = json.load(f)["manifests"]["stmfnet.pth"]["tensors"]
    with torch.device("meta"):
        sd = ps.STMFNet().state_dict()
    assert {k: list(v.shape) for k, v in sd.items()} == want
    params = ps.init_params(0)
    assert params.keys() == sd.keys() and len(params) == 1000


def test_init_params_is_seeded_and_norms_start_at_identity():
    a, b, c = ps.init_params(0), ps.init_params(0), ps.init_params(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["gauss_kernel"], c["gauss_kernel"])
    assert torch.equal(a["feature_extractor.conv1.resnext_small.bn1.running_var"], torch.ones(64))
    assert torch.equal(a["dyntex_generator.encoder.stem.1.running_mean"], torch.zeros(32))
    assert a["dyntex_generator.feature_fuse.1.num_batches_tracked"].dtype == torch.int64
    assert torch.equal(a["scale_synthesis.lateral_0_0.f.0.weight"], torch.full((1,), ps.PRELU_INIT))
    bound = 1 / np.sqrt(64 * 9)
    w = a["get_kernel.moduleWeight1.0.weight"]
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound


# ---- b. the two ops ----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 7, 9, 5), (1, 12, 10, 32)])
def test_correlation(shape):
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    ref = np.asarray(jax_correlation(jnp.asarray(a), jnp.asarray(b)))
    got = correlation_func(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (*shape[:3], 81)
    _close(got.numpy(), ref, "correlation", 1e-6)


def _adacof_case(name, rng, n=2, h=10, w=13, c=3, f=5, d=1):
    hp, wp = h + (f - 1) * d, w + (f - 1) * d
    img = rng.random((n, hp, wp, c), dtype=np.float32)
    weight = rng.random((n, h, w, f * f), dtype=np.float32)
    if name == "fractional":  # negative and positive fractional offsets, integers, -0.5
        alpha = rng.uniform(-3, 3, (n, h, w, f * f)).astype(np.float32)
        beta = rng.uniform(-3, 3, (n, h, w, f * f)).astype(np.float32)
        alpha[:, 0, 0, :4] = [-0.5, 0.5, -1.0, 2.0]
        beta[:, 0, 0, :4] = [-0.25, -2.75, 0.0, -1.5]
    else:  # offsets that clamp at every edge: far before, far past, one past
        alpha = rng.choice(np.asarray([-40.5, -h - 1.25, -0.75, 0.3, h + 0.5, 40.25], np.float32), (n, h, w, f * f))
        beta = rng.choice(np.asarray([-40.5, -w - 1.25, -0.75, 0.3, w + 0.5, 40.25], np.float32), (n, h, w, f * f))
    return img, weight, alpha, beta


@pytest.mark.parametrize("name,dilation,band", [
    ("fractional", 1, None), ("clamped", 1, None), ("fractional", 2, None), ("clamped", 1, 200),
])
def test_adacof(name, dilation, band, monkeypatch):
    if band is not None:  # many bands of a few rows each
        monkeypatch.setattr(padacof, "BAND_ELEMENTS", band)
    args = _adacof_case(name, np.random.default_rng(2), d=dilation)
    ref = np.asarray(jax_adacof(*(jnp.asarray(a) for a in args), dilation))
    got = padacof.adacof_func(*(torch.from_numpy(a) for a in args), dilation)
    assert got.dtype == torch.float32
    _close(got.numpy(), ref, f"adacof {name}", 1e-5)


def test_adacof_bf16_is_the_f32_result_rounded():
    args = _adacof_case("fractional", np.random.default_rng(3))
    t = [torch.from_numpy(a).bfloat16() for a in args]
    got = padacof.adacof_func(*t)
    ref = padacof.adacof_func(*(x.float() for x in t))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, ref.bfloat16())


def test_adacof_rejects_a_mismatched_input():
    img, weight, alpha, beta = (torch.from_numpy(a) for a in _adacof_case("fractional", np.random.default_rng(4)))
    with pytest.raises(ValueError, match="does not fit"):
        padacof.adacof_func(img[:, 1:], weight, alpha, beta)


# ---- c. the masked backwarp and the 8-tap upsampler ------------------------------------


def test_backwarp_masked_at_an_odd_width():
    rng = np.random.default_rng(5)
    x = rng.random((2, 13, 19, 5), dtype=np.float32)
    yy, xx = np.mgrid[0:13, 0:19].astype(np.float32)
    flow = np.stack([3.5 * np.sin(0.4 * yy + 0.2 * xx), 2.5 * np.cos(0.3 * xx - 0.1 * yy)], -1)[None].repeat(2, 0)
    ref = np.asarray(js._backwarp_masked(jnp.asarray(x), jnp.asarray(flow)))
    got = _nhwc(ps._backwarp_masked(_nchw(x), torch.from_numpy(flow).permute(0, 3, 1, 2)))
    np.testing.assert_array_equal(got == 0.0, ref == 0.0)  # the same pixels masked
    assert (ref == 0.0).any() and (ref != 0.0).any()
    _close(got, ref, "backwarp", 1e-6)


def test_upsampler_8tap():
    rng = np.random.default_rng(6)
    im = rng.random((2, 9, 13, 3), dtype=np.float32)
    filt = rng.uniform(-0.5, 0.5, (3, 1, 1, 8)).astype(np.float32)
    ref = np.asarray(js._upsampler_8tap(jnp.asarray(filt), jnp.asarray(im)))
    got = _nhwc(ps._upsampler_8tap(torch.from_numpy(filt), _nchw(im)))
    assert got.shape == (2, 18, 26, 3)
    _close(got, ref, "upsampler", 1e-6)


# ---- d. the stages, on the JAX stages' inputs -----------------------------------------------


def _demo_frames():
    """``demo_frames/seq/0-3.png`` every eighth pixel, uint8 ``[4, 68, 120, 3]``."""
    from PIL import Image

    imgs = [np.asarray(Image.open(os.path.join(ROOT, "demo_frames", "seq", f"{i}.png")).convert("RGB")) for i in range(4)]
    return np.stack(imgs)[:, ::8, ::8]


@jax.jit
def _jax_stages(p, i0, i1, i2, i3):
    """Every stage of JAX ``apply`` on padded frames, with its intermediates,
    and the PWC flows both ways (the first half of ``stage_flowsplat``)."""
    h, w = i1.shape[1], i1.shape[2]
    feats = js.stage_feats(p, i1, i2)
    adas = sum((js.stage_stream(p, feats, i1, i2, s) for s in ("", "_ds", "_us")), ())
    pwc = p["flow_estimator"]
    pyr1, pyr2 = js._pwc_extract(pwc["netExtractor"], i1), js._pwc_extract(pwc["netExtractor"], i2)
    flows = tuple(jc.resize_bilinear(20.0 * js._pwc_flow(pwc, a, b), (h, w)) for a, b in ((pyr1, pyr2), (pyr2, pyr1)))
    splats = js.stage_flowsplat(p, i1, i2)
    tilde = js.stage_synth(p, adas, splats)
    out = js.stage_dyntex(p, i0, i1, i2, i3, tilde)
    return {"feats": feats, "adas": adas, "flows": flows, "splats": splats, "tilde": tilde, "out": out}


@functools.lru_cache(maxsize=None)
def _jax_run(which):
    """The demo frames as floats, padded as JAX pads them, and the JAX stages'
    outputs with ``which`` weights."""
    frames = _demo_frames().astype(np.float32) / 255.0
    padded = js._pad128(*(jnp.asarray(f[None]) for f in frames))
    out = _jax_stages(_params(which)[1], *padded)
    return frames, [np.asarray(x) for x in padded], jax.tree_util.tree_map(np.asarray, out)


def test_pwc_flows_both_ways():
    _, (i0, i1, i2, i3), ref = _jax_run("perturbed")
    with torch.inference_mode():
        got = ps.pwc_flows(_net("perturbed").flow_estimator, _nchw(i1), _nchw(i2))
    for g, r, d in zip(got, ref["flows"], ("1->2", "2->1")):
        _close(_nhwc(g), r, f"pwc flow {d}")


def test_feature_extractor():
    _, (i0, i1, i2, i3), ref = _jax_run("perturbed")
    with torch.inference_mode():
        got = ps.stage_feats(_net("perturbed"), _nchw(i1), _nchw(i2))
    assert tuple(got.shape) == (1, 64, 64, 64)
    _close(_nhwc(got), ref["feats"], "features")


@pytest.mark.parametrize("k,suffix", [(0, ""), (1, "_ds"), (2, "_us")])
def test_stream(k, suffix):
    _, (i0, i1, i2, i3), ref = _jax_run("perturbed")
    with torch.inference_mode():
        got = ps.stage_stream(_net("perturbed"), _nchw(ref["feats"]), _nchw(i1), _nchw(i2), suffix)
    for g, r, frame in zip(got, ref["adas"][2 * k : 2 * k + 2], (1, 2)):
        _close(_nhwc(g), r, f"stream {suffix!r} frame {frame}")


def test_flow_splat():
    _, (i0, i1, i2, i3), ref = _jax_run("perturbed")
    with torch.inference_mode():
        got = ps.stage_flowsplat(_net("perturbed"), _nchw(i1), _nchw(i2))
    for g, r in zip(got, ref["splats"]):
        _close(_nhwc(g), r, "flow splat")


def test_gridnet():
    _, _, ref = _jax_run("perturbed")
    with torch.inference_mode():
        got = ps.stage_synth(_net("perturbed"), [_nchw(a) for a in ref["adas"]], [_nchw(s) for s in ref["splats"]])
    _close(_nhwc(got), ref["tilde"], "gridnet")


def test_unet3d():
    _, frames, ref = _jax_run("perturbed")
    with torch.inference_mode():
        got = ps.stage_dyntex(_net("perturbed"), *(_nchw(f) for f in frames), _nchw(ref["tilde"]))
    _close(_nhwc(got), ref["out"], "dyntex")


# ---- e. the model function -----------------------------------------------------------------


def test_make_model_fn_matches_jax_fp32_and_bf16():
    frames, _, ref = _jax_run("perturbed")
    want = ref["out"][:, :68, :120]
    f = [torch.from_numpy(x[None]) for x in frames]
    got = ps.make_model_fn(_params("perturbed")[0], device="cpu")(*f)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 68, 120, 3)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4
    got16 = ps.make_model_fn(_params("perturbed")[0], dtype=torch.bfloat16, device="cpu")(*f)
    assert got16.dtype == torch.float32
    assert psnr(got16.numpy(), want) >= 40.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_counts_equal_a_forward(dtype, monkeypatch):
    """The warps and splats of one forward on the CPU, routed by their planes
    as the card would route them, against ``warps_per_forward`` and
    ``splats_per_forward``; the warp widths in the order the model makes
    them: each PWC level's features, then the frames, each with its f32
    ones channel."""
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import warp_kernel

    seen = {"narrow": 0, "wide": 0, "widths": [], "splats": 0}
    real_warp, real_splat = ps.warp, ps.function_softsplat

    def warp_spy(img, flow, *args):
        planes = img.permute(0, 3, 1, 2)
        seen["wide" if warp_kernel.route(planes.shape, planes.stride(), planes.dtype) == "wide" else "narrow"] += 1
        seen["widths"].append((img.shape[-1], img.dtype))
        return real_warp(img, flow, *args)

    def splat_spy(*args):
        seen["splats"] += 1
        return real_splat(*args)

    monkeypatch.setattr(ps, "warp", warp_spy)
    monkeypatch.setattr(ps, "function_softsplat", splat_spy)
    f = [torch.rand(1, 40, 56, 3, generator=torch.Generator().manual_seed(i)) for i in range(4)]
    ps.make_model_fn(ps.init_params(0), dtype=dtype, device="cpu")(*f)
    assert {"narrow": seen["narrow"], "wide": seen["wide"]} == ps.warps_per_forward(dtype)
    assert seen["splats"] == ps.splats_per_forward()
    want = [w for c in ps.WARP_CHANNELS_PER_FORWARD for w in ((c, dtype), (1, torch.float32))]
    assert seen["widths"] == want


# ---- f. the golden ----------------------------------------------------------------------------


def make_golden(seed=GOLDEN_SEED):
    """JAX STMFNet fp32 on the four demo frames every eighth pixel, weights
    ``init_params(seed)``; the output cropped back to 68x120."""
    assert seed == GOLDEN_SEED
    frames, _, out = _jax_run("golden")
    return _demo_frames(), out["out"][:, :68, :120]


def test_golden_fixture_is_current_and_port_matches_it():
    with np.load(GOLDEN) as z:
        seed, frames, stored = int(z["seed"]), z["frames"], z["output"]
    assert seed == GOLDEN_SEED and stored.shape == (1, 68, 120, 3)
    np.testing.assert_array_equal(frames, _demo_frames())
    np.testing.assert_allclose(make_golden(seed)[1], stored, atol=1e-6, rtol=0)
    f = [torch.from_numpy(frames[i : i + 1].astype(np.float32) / 255.0) for i in range(4)]
    got = ps.make_model_fn(ps.init_params(seed), device="cpu")(*f)
    assert psnr(got.numpy(), stored) >= 40.0
    _close(got.numpy(), stored, "golden", 1e-4)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    frames, out = make_golden(GOLDEN_SEED)
    np.savez_compressed(GOLDEN, seed=np.int64(GOLDEN_SEED), frames=frames, output=out)
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
