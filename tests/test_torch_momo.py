"""The port's MoMo against the JAX package's, on the CPU, with the same weights
and the same numpy inputs and noise.

* ``ops.warp.bicubic_sample`` against JAX ``bicubic_sample`` (zeros and
  border; coordinates inside, around the edge and far outside; f32 and bf16
  images) at 128x192. The port samples through ``grid_sample`` on a grid
  normalized in f32, which rounds a coordinate by up to ~1.5e-5 px at
  w = 192; on [0, 1] noise the cubic interpolant moves by up to ~2 per px,
  so f32 is held within ``GRID_ATOL`` = 4e-5 (measured up to 1.9e-5), and
  bf16 within that plus half a bf16 ulp of the value (the port rounds its f32
  sum to bf16 once, as JAX does).
* ``common.resize_bicubic`` against JAX ``resize_bicubic`` at the shapes of
  ``tests/test_layers.py:119-122``, antialias on and off, within 1e-5.
* The DDPM timesteps (2-20 steps) equal JAX's; one ``step`` at t = 999, 124
  and a last step within 1e-6.
* The denoiser pass (``ConvexUpUNet`` = JAX ``_convex_up_unet``),
  ``_convex_upsampling8`` and ``_synthesize`` against the JAX functions in
  fp32, within 1e-4 (the pass's output reaches magnitudes of ~10: within
  1e-4 of the magnitude).
* The denoising loop's latents (3 steps, lite, the JAX loop built from JAX's
  own ``_convex_up_unet`` and ``DDPM``) within 1e-4 of JAX's.
* ``apply`` for lite and base at 128x192 with 3 steps, on noise drawn with
  ``numpy.random.default_rng`` and injected on both sides, on two sets of
  weights:

  - as drawn: the denoiser's predictions reach ~10 and mostly clip to +-1.
    fp32 >= 60 dB against JAX fp32 and within ``APPLY_ATOL`` = 5e-3: the
    flows are the latents times ``FLOW_SCALER`` = 128, so the latents' f32
    rounding (~2e-5, from the UNets' sums in another order) becomes ~3e-3 px
    of flow at the unclipped pixels, and moves a pixel by up to ~1e-3
    (measured).
  - conditioned (:func:`_conditioned`): the latent head and the mask head
    scaled down so that the predictions stay within ~0.2 (flows of up to ~25
    px, as trained weights give) and none clips. fp32 within 1e-4 of JAX
    fp32 (measured 2.7e-5 lite, 3.4e-5 base) and >= 40 dB; bf16 >= 30 dB
    against JAX fp32 (measured 33.90 dB lite, 34.85 dB base; JAX's own bf16
    36.00 and 37.14 dB). On the unconditioned weights bf16 reads ~22-25 dB in
    both packages, the rounding of the unclipped predictions times 128:
    there it tells a fault from rounding by nothing.
* Under bf16 the scheduler steps f32 latents and the synthesis gets f32
  flows (a PSNR bound cannot see that: keeping either in bf16 costs < 1 dB
  at 3 steps, measured).
* Weights come from JAX ``init_params`` through ``utils.ckpt.params_from_jax``,
  with the GroupNorm affine parameters redrawn with numpy, so that a swapped
  weight and bias cannot pass; the port's ``state_dict`` keys and shapes equal
  the flattened JAX tree.
* The JAX golden (``tests/fixtures/torch_port_momo_golden.npz``: the demo
  frames every fourth pixel cropped to 128x128, the seeds of the weights,
  the port's numpy ``init_params``, and of the noise, and JAX's lite output
  at 3 steps) is regenerated with JAX and must be unchanged; the port
  matches it at >= 60 dB.
* The node: x2 on 3 frames of 52x84 (edge-padded to 64x128 inside): the
  originals pass through bit for bit, the output is finite, the same seed
  gives the same frames and another seed others, a second call with the same
  params builds no second model; its schema equals the JAX node's.

Each JAX function runs jitted with the weights as an argument, one compile
per variant and shape. Run ``python tests/test_torch_momo.py`` to rewrite
the fixture.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.models import common as jcommon
from comfyui_frame_interpolation_tpu.models import momo as jm
from comfyui_frame_interpolation_tpu.nodes.vfi_nodes import MOMO_VFI as JaxMoMo
from comfyui_frame_interpolation_tpu.ops.warp import bicubic_sample as jax_bicubic
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch.models import momo as pm
from comfyui_frame_interpolation_tpu_torch.models.common import resize_bicubic
from comfyui_frame_interpolation_tpu_torch.nodes.vfi_nodes import MOMO_VFI as PortMoMo
from comfyui_frame_interpolation_tpu_torch.ops.warp import bicubic_sample
from comfyui_frame_interpolation_tpu_torch.utils.ckpt import params_from_jax
from torch_offline import no_downloads  # noqa: F401  (autouse: no download leaves the machine)
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "torch_port_momo_golden.npz")
GOLDEN_SEED = 2028
GOLDEN_NOISE_SEED = 2029
GOLDEN_CKPT = "momo-lite.pth"
HW = (128, 192)
STEPS = 3
GRID_ATOL = 4e-5
APPLY_ATOL = 5e-3


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def _is_gn(key: str) -> bool:
    return ".norm" in key or "conv_norm_out" in key or "proj_out.0." in key


@functools.lru_cache(maxsize=None)
def _weights(ckpt):
    """JAX ``init_params(PRNGKey(0), ckpt)`` as the port's state dict, the
    GroupNorms' weights redrawn in [0.5, 1.5] and biases in [-0.5, 0.5] with
    numpy; and the same weights as a JAX tree."""
    sd = params_from_jax(jax.jit(lambda k: jm.init_params(k, ckpt))(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for k in sorted(sd):
        if _is_gn(k):
            lo, hi = (0.5, 1.5) if k.endswith("weight") else (-0.5, 0.5)
            sd[k] = torch.from_numpy(rng.uniform(lo, hi, tuple(sd[k].shape)).astype(np.float32))
    return sd, to_jax_tree(nest_state_dict(sd))


@functools.lru_cache(maxsize=None)
def _conditioned(ckpt):
    """:func:`_weights` with ``model.mid_model.conv_out`` (the 1/8-resolution
    latent the convex upsampling spreads) times 0.02 and the mask head
    ``model.out_up.proj_out.2`` times 0.1: the denoiser's predictions stay
    within ~0.2 and none clips."""
    sd = dict(_weights(ckpt)[0])
    for k in sd:
        if k.startswith("model.mid_model.conv_out."):
            sd[k] = sd[k] * 0.02
        elif k.startswith("model.out_up.proj_out.2."):
            sd[k] = sd[k] * 0.1
    return sd, to_jax_tree(nest_state_dict(sd))


def _inputs(seed, hw=HW, steps=STEPS):
    """Two frames in [0, 1] and the noise (initial latent, then one per
    step), NHWC numpy from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    x0, x1 = (rng.random((1, *hw, 3), dtype=np.float32) for _ in range(2))
    noises = [rng.standard_normal((1, *hw, 4)).astype(np.float32) for _ in range(steps + 1)]
    return x0, x1, noises


# ------------------------------------------------------------------ samplers


def _coords(kind, n, h, w, rng):
    if kind == "inside":
        return rng.uniform(0, w - 1, (n, h, w)), rng.uniform(0, h - 1, (n, h, w))
    if kind == "edge":  # about the border: the taps straddle it, integers and half pixels included
        sx = rng.choice([-2.5, -1.5, -1.0, -0.5, 0.0, 0.5, w - 1.5, w - 1.0, w - 0.5, w + 0.5], (n, h, w))
        sy = rng.choice([-2.0, -0.5, 0.0, 0.25, h - 1.0, h - 0.5, h + 1.0], (n, h, w))
        return sx + rng.uniform(-0.2, 0.2, (n, h, w)), sy
    return rng.uniform(-4 * w, 5 * w, (n, h, w)), rng.uniform(-4 * h, 5 * h, (n, h, w))


@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("kind", ["inside", "edge", "far"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bicubic_sample_matches_jax(mode, kind, dtype):
    rng = np.random.default_rng(3 * ["zeros", "border"].index(mode) + ["inside", "edge", "far"].index(kind))
    n, (h, w), c = 2, HW, 3
    img = rng.random((n, h, w, c), dtype=np.float32)
    sx, sy = (v.astype(np.float32) for v in _coords(kind, n, h, w, rng))
    timg = torch.from_numpy(img).to(getattr(torch, dtype))
    got = bicubic_sample(timg, torch.from_numpy(sx), torch.from_numpy(sy), mode)
    assert got.dtype == timg.dtype and tuple(got.shape) == (n, h, w, c)
    # JAX in f32 on the image as the port was given it
    want = np.asarray(jax_bicubic(jnp.asarray(timg.float().numpy()), jnp.asarray(sx), jnp.asarray(sy), mode))
    err = np.abs(got.float().numpy() - want)
    if dtype == "float32":
        assert err.max() <= GRID_ATOL
    else:
        half_ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126))) - 8)
        assert (err <= half_ulp + GRID_ATOL).all()


@pytest.mark.parametrize("out_hw", [(32, 48), (8, 6), (15, 21)])
@pytest.mark.parametrize("antialias", [False, True])
def test_resize_bicubic_matches_jax(out_hw, antialias):
    x = np.random.default_rng(7).standard_normal((2, 16, 24, 3)).astype(np.float32)
    got = resize_bicubic(nchw(x), out_hw, antialias=antialias)
    want = np.asarray(jcommon.resize_bicubic(jnp.asarray(x), out_hw, antialias=antialias))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("out_hw", [(8, 12), (32, 48)])
@pytest.mark.parametrize("antialias", [False, True])
def test_resize_bicubic_bf16_is_f32_cast_once(out_hw, antialias):
    x = torch.from_numpy(np.random.default_rng(8).random((1, 3, 16, 24), dtype=np.float32)).bfloat16()
    got = resize_bicubic(x, out_hw, antialias=antialias)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, resize_bicubic(x.float(), out_hw, antialias=antialias).bfloat16())


# ------------------------------------------------------------------ scheduler


def test_ddpm_timesteps_equal_jax():
    for steps in range(2, 21):
        np.testing.assert_array_equal(pm.DDPM().timesteps(steps), jm.DDPM().timesteps(steps))
    assert list(pm.DDPM().timesteps(8)) == [999, 874, 749, 624, 499, 374, 249, 124]


@pytest.mark.parametrize("t,steps", [(999, 8), (124, 8), (332, 3)])
def test_ddpm_step_matches_jax(t, steps):
    rng = np.random.default_rng(t)
    pred, sample, noise = (rng.standard_normal((1, 8, 8, 4)).astype(np.float32) * s for s in (3.0, 1.0, 1.0))
    want = np.asarray(jm.DDPM().step(jnp.asarray(pred), t, jnp.asarray(sample), steps, jnp.asarray(noise)))
    got = pm.DDPM().step(torch.from_numpy(pred), t, torch.from_numpy(sample), steps, torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ------------------------------------------------------------------ the model's parts


def test_state_dict_equals_the_jax_tree_and_is_seeded():
    for ckpt in pm.CKPT_NAMES:
        shapes = jax.eval_shape(lambda k: jm.init_params(k, ckpt), jax.random.PRNGKey(0))
        want = {k: tuple(v.shape) for k, v in params_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)).items()}
        sd = pm.init_params(0, ckpt)
        assert {k: tuple(v.shape) for k, v in sd.items()} == want
        assert len(sd) == {"momo-base.pth": 252, "momo-lite.pth": 190}[ckpt]
        assert all(torch.equal(sd[k], torch.ones_like(sd[k]) if k.endswith("weight") else torch.zeros_like(sd[k])) for k in sd if _is_gn(k))
    a, b, c = pm.init_params(0, "momo-lite.pth"), pm.init_params(0, "momo-lite.pth"), pm.init_params(1, "momo-lite.pth")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["synth_model.decoder.3.weight"], c["synth_model.decoder.3.weight"])


@functools.lru_cache(maxsize=None)
def _jax_unet(ckpt):
    dims = jm._DIMS[ckpt]
    return jax.jit(lambda p, lat, x0, x1, t: jm._convex_up_unet(p["model"], lat, x0, x1, t, dims))


def test_denoiser_pass_matches_jax():
    ckpt = "momo-lite.pth"
    sd, jt = _weights(ckpt)
    x0, x1, noises = _inputs(3)
    t = np.array([874.0], np.float32)
    want = np.asarray(_jax_unet(ckpt)(jt, noises[0], x0, x1, t))
    net = pm._load(sd, ckpt, torch.float32, "cpu")
    with torch.inference_mode():
        got = nhwc(net.model(nchw(noises[0]), nchw(x0), nchw(x1), torch.from_numpy(t)))
    assert got.shape == (1, *HW, 4)
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max())


def test_convex_upsampling_matches_jax():
    rng = np.random.default_rng(4)
    flow = rng.standard_normal((2, 6, 10, 4)).astype(np.float32)
    mask = (rng.standard_normal((2, 6, 10, 2 * 9 * 64)) * 3).astype(np.float32)
    want = np.asarray(jm._convex_upsampling8_impl(jnp.asarray(flow), jnp.asarray(mask)))
    got = pm._convex_upsampling8(nchw(flow), nchw(mask))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 4, 48, 80)
    np.testing.assert_allclose(nhwc(got), want, rtol=0, atol=1e-5)


_jax_synthesize = jax.jit(lambda p, f, fl: jm._synthesize(p["synth_model"], f, fl))


@pytest.mark.parametrize("flow_scale", [4.0, 128.0])
def test_synthesize_matches_jax(flow_scale):
    """Flows of a few pixels, and flows as large as the clipped latents give
    (up to ``FLOW_SCALER``), across 2 levels at 128x192."""
    sd, jt = _weights("momo-lite.pth")
    x0, x1, _ = _inputs(5)
    rng = np.random.default_rng(6)
    flows = (np.clip(rng.standard_normal((1, *HW, 4)), -1, 1) * flow_scale).astype(np.float32)
    f6 = np.concatenate([x0, x1], -1)
    want = np.asarray(_jax_synthesize(jt, f6, flows))
    net = pm._load(sd, "momo-lite.pth", torch.float32, "cpu")
    with torch.inference_mode():
        got = nhwc(pm._synthesize(net.synth_model, nchw(f6), nchw(flows)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_denoising_loop_latents_match_jax():
    """The latents after 3 steps, the JAX loop written with JAX's own
    ``_convex_up_unet`` and ``DDPM``: the quantity the flows are 128 times."""
    ckpt = "momo-lite.pth"
    sd, jt = _weights(ckpt)
    x0, x1, noises = _inputs(3)
    f6 = np.concatenate([x0, x1], -1).reshape(1, -1)
    xn = ((np.concatenate([x0, x1], -1) - f6.mean()) / (f6.std(ddof=1) + 1e-8)).astype(np.float32)
    sched, lat = jm.DDPM(), jnp.asarray(noises[0])
    for i, t in enumerate(sched.timesteps(STEPS)):
        pred = _jax_unet(ckpt)(jt, lat, xn[..., :3], xn[..., 3:], np.full((1,), float(t), np.float32))
        lat = sched.step(pred, int(t), lat, STEPS, jnp.asarray(noises[i + 1]))
    net = pm._load(sd, ckpt, torch.float32, "cpu")
    with torch.inference_mode():
        feats = net.model.encode_frames(nchw(xn[..., :3]), nchw(xn[..., 3:]))
        psched, plat = pm.DDPM(), nchw(noises[0])
        for i, t in enumerate(psched.timesteps(STEPS)):
            pred = net.model.denoise(plat, feats, torch.full((1,), float(t)))
            plat = psched.step(pred, int(t), plat, STEPS, nchw(noises[i + 1]))
    np.testing.assert_allclose(nhwc(plat), np.asarray(lat), rtol=0, atol=1e-4)


# ------------------------------------------------------------------ apply


@functools.lru_cache(maxsize=None)
def _jax_apply(ckpt, steps):
    return jax.jit(lambda p, x0, x1, n0, ns: jm.apply(
        p, x0, x1, num_inference_steps=steps, ckpt_name=ckpt, init_latents=n0, step_noises=ns))


def _port_apply(sd, ckpt, x0, x1, noises, dtype):
    net = pm._load(sd, ckpt, dtype, "cpu")
    with torch.inference_mode():
        out = pm.apply(net, nchw(x0).to(dtype), nchw(x1).to(dtype), len(noises) - 1,
                       init_latents=nchw(noises[0]), step_noises=[nchw(n) for n in noises[1:]])
    assert out.dtype == torch.float32
    return nhwc(out)


@pytest.mark.parametrize("ckpt", ["momo-lite.pth", "momo-base.pth"])
def test_apply_matches_jax(ckpt):
    sd, jt = _weights(ckpt)
    x0, x1, noises = _inputs(9)
    fn = _jax_apply(ckpt, STEPS)
    want = np.asarray(fn(jt, x0, x1, noises[0], noises[1:]))
    got = _port_apply(sd, ckpt, x0, x1, noises, torch.float32)
    assert got.shape == want.shape == (1, *HW, 3) and np.isfinite(got).all()
    p32 = psnr(got, want)
    assert p32 >= 60.0 and np.abs(got - want).max() <= APPLY_ATOL
    # conditioned weights: nothing clips, so fp32 and bf16 are held at fixed bounds
    csd, cjt = _conditioned(ckpt)
    cwant = np.asarray(fn(cjt, x0, x1, noises[0], noises[1:]))
    cgot = _port_apply(csd, ckpt, x0, x1, noises, torch.float32)
    c32, cerr = psnr(cgot, cwant), np.abs(cgot - cwant).max()
    got16 = _port_apply(csd, ckpt, x0, x1, noises, torch.bfloat16)
    j16 = jcommon.cast_params(cjt, jnp.bfloat16)
    want16 = np.asarray(fn(j16, x0.astype(jnp.bfloat16), x1.astype(jnp.bfloat16), noises[0], noises[1:]), np.float32)
    p16, jax16 = psnr(got16, cwant), psnr(want16, cwant)
    print(f"{ckpt}: port fp32 {p32:.2f} dB; conditioned: port fp32 {c32:.2f} dB (max abs err {cerr:.3g}), "
          f"port bf16 {p16:.2f} dB, JAX bf16 {jax16:.2f} dB against JAX fp32")
    assert c32 >= 40.0 and cerr <= 1e-4
    assert np.isfinite(got16).all() and p16 >= 30.0


def test_bf16_keeps_latents_and_flows_in_f32(monkeypatch):
    seen = []
    step, synthesize = pm.DDPM.step, pm._synthesize

    def spy_step(self, model_output, t, sample, steps, noise):
        out = step(self, model_output, t, sample, steps, noise)
        seen.append(("step", model_output.dtype, sample.dtype, noise.dtype, out.dtype))
        return out

    def spy_synthesize(net, frames6, flows4):
        seen.append(("synthesize", frames6.dtype, flows4.dtype))
        return synthesize(net, frames6, flows4)

    monkeypatch.setattr(pm.DDPM, "step", spy_step)
    monkeypatch.setattr(pm, "_synthesize", spy_synthesize)
    x0, x1, noises = _inputs(12, hw=(64, 64), steps=2)
    out = _port_apply(pm.init_params(0, "momo-lite.pth"), "momo-lite.pth", x0, x1, noises, torch.bfloat16)
    assert np.isfinite(out).all()
    f32 = torch.float32
    assert seen == [("step", f32, f32, f32, f32)] * 2 + [("synthesize", torch.bfloat16, f32)]


# ------------------------------------------------------------------ golden


def _golden_frames():
    """``anime0.png`` and ``anime1.png`` every fourth pixel, cropped to
    128x128, uint8 ``[2, 1, 128, 128, 3]``."""
    from PIL import Image

    imgs = [np.asarray(Image.open(os.path.join(ROOT, "demo_frames", f"anime{i}.png")).convert("RGB")) for i in (0, 1)]
    return np.stack(imgs)[:, None, ::4, ::4][:, :, :128, :128]


def make_golden(seed=GOLDEN_SEED, noise_seed=GOLDEN_NOISE_SEED):
    """JAX MoMo lite fp32, 3 steps, on the golden frames, the port's
    ``init_params(seed)`` weights and ``default_rng(noise_seed)`` noise."""
    frames = _golden_frames()
    f = frames.astype(np.float32) / 255.0
    _, _, noises = _inputs(noise_seed, hw=(128, 128))
    jt = to_jax_tree(nest_state_dict(pm.init_params(seed, GOLDEN_CKPT)))
    return frames, np.asarray(_jax_apply(GOLDEN_CKPT, STEPS)(jt, f[0], f[1], noises[0], noises[1:]))


def test_golden_fixture_is_current_and_port_matches_it():
    with np.load(GOLDEN) as z:
        seed, noise_seed, frames, stored = int(z["seed"]), int(z["noise_seed"]), z["frames"], z["output"]
    assert (seed, noise_seed) == (GOLDEN_SEED, GOLDEN_NOISE_SEED) and stored.shape == (1, 128, 128, 3)
    np.testing.assert_array_equal(frames, _golden_frames())
    np.testing.assert_allclose(make_golden(seed, noise_seed)[1], stored, atol=1e-6, rtol=0)
    f = frames.astype(np.float32) / 255.0
    _, _, noises = _inputs(noise_seed, hw=(128, 128))
    got = _port_apply(pm.init_params(seed, GOLDEN_CKPT), GOLDEN_CKPT, f[0], f[1], noises, torch.float32)
    assert psnr(got, stored) >= 60.0 and np.abs(got - stored).max() <= APPLY_ATOL


# ------------------------------------------------------------------ node


def _no_tooltips(schema):
    if isinstance(schema, dict):
        return {k: _no_tooltips(v) for k, v in schema.items() if k != "tooltip"}
    if isinstance(schema, (tuple, list)):
        return type(schema)(_no_tooltips(v) for v in schema)
    return schema


def test_node_schema_equals_jax_node():
    assert _no_tooltips(PortMoMo.INPUT_TYPES()) == _no_tooltips(JaxMoMo.INPUT_TYPES())
    assert "TPU" not in str(PortMoMo.INPUT_TYPES())
    for attr in ("RETURN_TYPES", "FUNCTION", "CATEGORY"):
        assert getattr(PortMoMo, attr) == getattr(JaxMoMo, attr)


def test_node_runs_seeded_and_builds_its_model_once():
    frames = np.random.default_rng(10).random((3, 52, 84, 3), dtype=np.float32)
    sd = pm.init_params(0, "momo-lite.pth")
    node = PortMoMo()
    kw = dict(num_inference_steps=2, params=sd, device="cpu")
    (a,) = node.vfi("momo-lite.pth", frames, **kw)
    (b,) = node.vfi("momo-lite.pth", frames, **kw)
    assert len(node._model_fns) == 1
    (c,) = node.vfi("momo-lite.pth", frames, seed=1, **kw)
    assert a.dtype == torch.float32 and tuple(a.shape) == (5, 52, 84, 3) and bool(torch.isfinite(a).all())
    np.testing.assert_array_equal(a.numpy()[::2], frames)
    assert torch.equal(a, b) and not torch.equal(a[1::2], c[1::2])
    with pytest.raises(ValueError, match="at least 2 frames"):
        node.vfi("momo-lite.pth", frames[:1], **kw)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    frames, out = make_golden()
    np.savez_compressed(GOLDEN, seed=np.int64(GOLDEN_SEED), noise_seed=np.int64(GOLDEN_NOISE_SEED), frames=frames, output=out)
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
