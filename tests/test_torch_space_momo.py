"""MoMo on the ``space`` axis of the port's ``parallel/`` (rows split over
devices) through ``make_sharded_model_fn`` and ``run_plan``, against the
JAX package and against the port's own one-device runs, on logical
replicas of the CPU; and MoMo's noise under a data split.

MoMo's functions that read more rows than their own hand their row bands
over to ``parallel.space``'s rules: the GroupNorm (statistics from the
bands' partial sums), the replicate pad (a halo row, the edge replicated at
the frame's top and bottom only), the x8 convex upsampling (a halo row),
the frames' mean and std (``std_mean`` from partial sums), the
antialiased bicubic pyramid and the plain bicubic upscales
(``common.resize_bicubic``: the rows' taps of the global ratio, with the
weights of torch's own kernel), the bicubic backwarp (the source gathered
whole) and the noise (drawn whole, cut into the frames' bands). MoMo keeps
its GroupNorm and frame statistics and its antialiased resizes in f32 in
every dtype, so its "f64" runs round in f32 there.

* The data split: MoMo lite on a ``(2, 1)`` mesh (two data shards, no row
  split), batch 2, seed 0, 2 steps, 64x64. Each shard draws the whole
  batch's noise from the seed and keeps its own samples
  (``batch_slice``), so its draws are bit for bit one device's rows (before
  this, each shard drew its own batch from the seed again: 0.46 max abs
  off, ``ROADMAP.md`` Queue 3). In f64 the frames are bit for bit one
  device's. In f32 they are within 1e-4 (measured 1.35e-5; 5.8e-4 on the
  weights as drawn): the CPU's convolutions (oneDNN) and products (one
  sample's time embedding takes a matrix-vector product) round otherwise at
  batch 1 than at batch 2, and FLOW_SCALER's x128 carries that into the
  frames: the split is bit for bit one device's two batch-1 calls on the
  same noise (asserted), which are exactly as far from its batch-2 call.
* On a ``(4, 2)`` mesh, 5 frames x 256x128 f32 through ``run_plan``
  (``plan_timestep(5, 2)``, batch 4: each data shard one pair, two bands of
  128 rows), MoMo lite with conditioned heads (the latent head x0.02, the
  mask head x0.1, as ``chip_smoke.momo_conditioned``: no prediction clips;
  the GroupNorms' affine redrawn with numpy, so that a swapped weight and
  bias cannot pass), 2 steps, on numpy noise injected on both sides, against
  JAX's one-device ``apply`` (``init_latents``/``step_noises``) within 1e-4
  (``tests/test_torch_momo.py``'s; measured 3.4e-5, one device 2.8e-5).
* Seed-drawn noise on ``(1, 2)`` and ``(2, 2)`` meshes, 3 frames x
  256x128, batch 2, in f64 against the port's one device with the same
  seed: every draw bit for bit one device's rows, the frames within 5e-5
  (measured 1.39e-5 on both: f32 rounding of the statistics and the
  antialiased resizes, times 128; one device moves 1.07e-5 for one frame
  one f32 ulp up).
* The synthesis pyramid at 256x256 (three levels: 1/4, 1/2, 1) on three
  uneven bands in f64 within 1e-6 of the whole frame's (measured 1.2e-7).
* Each hand-over alone on three uneven bands, the edges off every stride,
  against the whole tensor in f64: the replicate pad, the backwarp, the
  convex upsampling and the noise's cut bit for bit; the group norm and the
  mean/std (f32 statistics) within 5e-6 (measured 6.5e-7 and 6.0e-8);
  the antialiased downscales by 2, 4, 8 and 32 (f32 inside) within 2e-6
  (measured 3.6e-7 to 3.7e-8) and the plain bicubic upscales (by 2, and 9 -> 17 rows
  as the synthesis UNet's coarsest level makes) within 1e-12 (measured 0).

One JAX compile (``apply`` at 4 x 256x128, the weights an argument).

``PYTHONPATH=.:tests python tests/test_torch_space_momo.py`` prints the
gaps these tolerances rest on.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.models import momo as jm
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch import parallel
from comfyui_frame_interpolation_tpu_torch.core.loop import run_plan
from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_timestep
from comfyui_frame_interpolation_tpu_torch.models import common, momo
from comfyui_frame_interpolation_tpu_torch.parallel import space
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the script at the repository's root; it imports nothing heavy)

CPU = torch.device("cpu")
CKPT = "momo-lite.pth"
H, W, STEPS = 256, 128, 2
JAX_ATOL = 1e-4  # tests/test_torch_momo.py's, conditioned f32
DATA_F32_ATOL = 1e-4
F64_ATOL = 5e-5
SYNTH_ATOL = 1e-6
STATS_ATOL = 5e-6
AA_ATOL = 2e-6
PLAIN_ATOL = 1e-12


def _replicas(n):
    return [CPU] * n


def _is_gn(key):
    return ".norm" in key or "conv_norm_out" in key or "proj_out.0." in key


@functools.lru_cache(maxsize=None)
def _params(ckpt=CKPT):
    """``init_params(0)`` with the GroupNorms' affine redrawn with numpy
    and the heads conditioned (``chip_smoke.momo_conditioned``); and the
    same weights as a JAX tree."""
    sd = momo.init_params(0, ckpt)
    rng = np.random.default_rng(1)
    for k in sorted(sd):
        if _is_gn(k):
            lo, hi = (0.5, 1.5) if k.endswith("weight") else (-0.5, 0.5)
            sd[k] = torch.from_numpy(rng.uniform(lo, hi, tuple(sd[k].shape)).astype(np.float32))
    sd = chip_smoke.momo_conditioned(sd)
    return sd, to_jax_tree(nest_state_dict(sd))


def _frames(n, h=H, w=W, seed=90):
    return np.random.default_rng(seed).random((n, h, w, 3), np.float32)


def _run(frames, make, mesh=None, batch_size=2):
    fn = make(CPU) if mesh is None else parallel.make_sharded_model_fn(make, mesh)
    return run_plan(torch.from_numpy(frames), plan_timestep(len(frames), 2), fn, batch_size=batch_size)


def _seeded(dtype, ckpt=CKPT):
    return lambda d: momo.make_model_fn(_params(ckpt)[0], ckpt, num_inference_steps=STEPS, seed=0, dtype=dtype, device=d)


def _draws(monkeypatch):
    """The noise of every draw, as ``apply`` cuts it into the frames' bands."""
    seen = []
    cut = momo._as_frame

    def spy(noise, frame):
        seen.append(noise.clone())
        if isinstance(frame, space.RowBands):  # its rule, which the hand-over would look up by the spy's name
            return space._RULES[cut](cut, (noise, frame), {})
        return cut(noise, frame)

    monkeypatch.setattr(momo, "_as_frame", spy)
    return seen


def _shard_draws_are_one_devices(split, one, shards):
    """Shard ``i``'s draws (``STEPS + 1`` of them, made one shard after the
    other) are rows ``i * per`` to ``(i + 1) * per`` of one device's."""
    per = one[0].shape[0] // shards
    assert len(split) == shards * len(one) == shards * (STEPS + 1)
    for i in range(shards):
        for k, whole in enumerate(one):
            assert torch.equal(split[i * len(one) + k], whole[i * per : (i + 1) * per])


# ---- the data split ---------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_seed_gives_one_devices_frames_on_a_data_split(monkeypatch, dtype):
    rng = np.random.default_rng(91)
    f0, f1 = (torch.from_numpy(rng.random((2, 64, 64, 3), np.float32)) for _ in range(2))
    t = torch.full((2,), 0.5)
    make = _seeded(dtype)
    seen = _draws(monkeypatch)
    one = make(CPU)(f0, f1, t)
    one_draws, seen[:] = list(seen), []
    mesh = parallel.make_mesh(2, shape=(2, 1), devices=_replicas(2))
    two = parallel.make_sharded_model_fn(make, mesh)(f0, f1, t)
    _shard_draws_are_one_devices(seen, one_draws, 2)
    assert two.shape == one.shape == (2, 64, 64, 3)
    if dtype == torch.float64:
        assert torch.equal(two, one)
    else:
        torch.testing.assert_close(two, one, rtol=0, atol=DATA_F32_ATOL)
        # the gap is batch 1 against batch 2 on the same noise, and nothing else
        per = torch.cat([make(CPU)(f0[i : i + 1], f1[i : i + 1], t[:1], batch_slice=(i, 2)) for i in range(2)])
        assert torch.equal(two, per)


# ---- the row split ------------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _noise(total, h=H, w=W, seed=92):
    """The initial latent and one noise per step, NHWC numpy."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((total, h, w, 4)).astype(np.float32) for _ in range(STEPS + 1)]


def _injected(noise, dtype=torch.float32):
    """The model callable on ``noise`` (the whole batch's), each shard's
    samples picked by its ``batch_slice``."""

    def make(device):
        net = momo._load(_params()[0], CKPT, dtype, device)

        @torch.inference_mode()
        def fn(f0, f1, t=None, batch_slice=None):
            b = f0.shape[0]
            start, _ = batch_slice or (0, b)
            given = [torch.from_numpy(n[start : start + b]).permute(0, 3, 1, 2) for n in noise]

            def nchw(f):
                return f.to(device=device, dtype=dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

            out = momo.apply(net, nchw(f0), nchw(f1), STEPS, init_latents=given[0], step_noises=given[1:])
            return out.clamp(0.0, 1.0).permute(0, 2, 3, 1).float()

        return fn

    return make


@functools.lru_cache(maxsize=None)
def _jax_one_device():
    """JAX's ``apply`` on one device, the 4 pairs of 5 frames x 256x128 in
    one batch, on the injected noise."""
    frames = _frames(5)
    fn = jax.jit(lambda p, a, b, n0, n1, n2: jm.apply(p, a, b, None, STEPS, CKPT, init_latents=n0, step_noises=[n1, n2]))
    out = fn(_params()[1], jnp.asarray(frames[:-1]), jnp.asarray(frames[1:]), *(jnp.asarray(n) for n in _noise(4)))
    return np.asarray(out)


def test_momo_on_a_4x2_mesh_matches_jax_one_device():
    frames = _frames(5)
    mesh = parallel.make_mesh(8, devices=_replicas(8))
    assert dict(mesh.shape) == {"data": 4, "space": 2}
    assert parallel.frame_sharding(mesh, frames.shape).spec == ("data", "space", None, None)
    out = _run(frames, _injected(_noise(4)), mesh, batch_size=4)
    assert out.shape == (9, H, W, 3)
    np.testing.assert_allclose(out[1::2].numpy(), _jax_one_device(), rtol=0, atol=JAX_ATOL)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_seeded_noise_on_a_row_split_matches_one_device_in_f64(monkeypatch, shape):
    frames = _frames(3, seed=93)
    mesh = parallel.make_mesh(shape[0] * shape[1], shape=shape, devices=_replicas(shape[0] * shape[1]))
    seen = _draws(monkeypatch)
    ref = _run(frames, _seeded(torch.float64))
    one_draws, seen[:] = list(seen), []
    out = _run(frames, _seeded(torch.float64), mesh)
    _shard_draws_are_one_devices(seen, one_draws, shape[0])
    assert out.shape == ref.shape == (5, H, W, 3)
    torch.testing.assert_close(out, ref, rtol=0, atol=F64_ATOL)


# ---- each handed-over function alone, band by band ------------------------------------------

SPANS = ((0, 7), (7, 9), (16, 4))  # three uneven bands of 20 rows
SPANS64 = ((0, 21), (21, 27), (48, 16))  # of 64 rows, the edges off every stride


def _bands(x, spans=SPANS, axis=2):
    return space.RowBands([x.narrow(axis, a, n) for a, n in spans], [a for a, _ in spans], x.shape[axis], axis)


def _nchw(seed, c, h=20, w=12, b=2, scale=1.0, dtype=torch.float64):
    x = np.random.default_rng(seed).standard_normal((b, c, h, w)) * scale
    return torch.from_numpy(x).to(dtype).contiguous(memory_format=torch.channels_last)


def _close(got, ref, atol):
    got = got.gather(CPU) if isinstance(got, space.RowBands) else got
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if atol == 0:
        assert torch.equal(got, ref)
    else:
        torch.testing.assert_close(got, ref, rtol=0, atol=atol)


def test_group_norm_silu_on_bands():
    gn = torch.nn.GroupNorm(momo.GROUPS, 64).double()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 64)))
        gn.bias.copy_(torch.from_numpy(rng.uniform(-0.5, 0.5, 64)))
    x = _nchw(1, 64, scale=3.0) + 1.0
    _close(momo._group_norm_silu(_bands(x), gn), momo._group_norm_silu(x, gn), STATS_ATOL)


def test_replicate_pad_on_bands_bit_for_bit():
    x = _nchw(2, 5)
    got = momo._replicate_pad1(_bands(x))
    assert got.starts == (0, 8, 17) and got.height == 22
    _close(got, momo._replicate_pad1(x), 0)


def test_convex_upsampling_on_bands_bit_for_bit():
    flow, mask = _nchw(3, 4, scale=2.0), _nchw(4, 2 * 9 * 64, scale=3.0)
    got = momo._convex_upsampling8(_bands(flow), _bands(mask))
    assert got.starts == (0, 56, 128) and got.height == 160
    _close(got, momo._convex_upsampling8(flow, mask), 0)


def test_mean_std_on_bands():
    x = _nchw(5, 6) + 0.5
    for got, ref in zip(momo._mean_std(_bands(x)), momo._mean_std(x)):
        _close(got, ref, STATS_ATOL)


def test_backwarp_on_bands_bit_for_bit():
    img, flow = _nchw(6, 3), _nchw(7, 2, scale=6.0)  # flows across the bands' edges and off the frame
    _close(momo._backwarp(_bands(img, SPANS), _bands(flow, ((0, 11), (11, 2), (13, 7)))), momo._backwarp(img, flow), 0)


def test_noise_cut_into_bands_bit_for_bit():
    x, noise = _nchw(8, 3), _nchw(9, 4, dtype=torch.float32)
    got = momo._as_frame(noise, _bands(x))
    assert got.starts == (0, 7, 16)
    _close(got, noise, 0)


@pytest.mark.parametrize("factor", [2, 4, 8, 32])
def test_antialiased_downscale_on_bands(factor):
    x = _nchw(10 + factor, 3, h=128 if factor == 32 else 64, w=64)
    spans = ((0, 45), (45, 38), (83, 45)) if factor == 32 else SPANS64
    size = (x.shape[2] // factor, x.shape[3] // factor)
    _close(common.resize_bicubic(_bands(x, spans), size, antialias=True), common.resize_bicubic(x, size, antialias=True), AA_ATOL)


@pytest.mark.parametrize("rows", [(64, 128), (9, 17)], ids=["by 2", "9 to 17"])
def test_plain_bicubic_upscale_on_bands(rows):
    h, out_h = rows
    x = _nchw(20, 8, h=h)
    spans = SPANS64 if h == 64 else ((0, 3), (3, 4), (7, 2))
    size = (out_h, 2 * x.shape[3])
    _close(common.resize_bicubic(_bands(x, spans), size), common.resize_bicubic(x, size), PLAIN_ATOL)


def test_synthesis_pyramid_on_bands():
    """``_synthesize`` at 256x256 (three levels, 1/4 to 1) on three uneven
    bands: every resize, backwarp, pad and strided convolution of the
    pyramid on bands."""
    net = momo._load(_params()[0], CKPT, torch.float64, CPU).synth_model
    frames6 = _nchw(30, 6, h=256, w=256, b=1) * 0.2 + 0.5
    flows4 = _nchw(31, 4, h=256, w=256, b=1, scale=4.0)
    spans = ((0, 100), (100, 50), (150, 106))
    with torch.inference_mode():
        got = momo._synthesize(net, _bands(frames6, spans), _bands(flows4, ((0, 96), (96, 64), (160, 96))))
        ref = momo._synthesize(net, frames6, flows4)
    _close(got, ref, SYNTH_ATOL)


def _gaps():
    """The gaps behind the tolerances."""
    out = {"port split (4, 2) vs jax one device": float(np.abs(
        _run(_frames(5), _injected(_noise(4)), parallel.make_mesh(8, devices=_replicas(8)), batch_size=4)[1::2].numpy()
        - _jax_one_device()).max())}
    out["port one device vs jax one device"] = float(np.abs(_run(_frames(5), _injected(_noise(4)), batch_size=4)[1::2].numpy()
                                                           - _jax_one_device()).max())
    frames = _frames(3, seed=93)
    ref = _run(frames, _seeded(torch.float64))
    for shape in ((1, 2), (2, 2)):
        mesh = parallel.make_mesh(shape[0] * shape[1], shape=shape, devices=_replicas(shape[0] * shape[1]))
        out[f"port split {shape} vs port one device, f64"] = float((_run(frames, _seeded(torch.float64), mesh) - ref).abs().max())
    nudged = frames.copy()
    nudged[0] = np.nextafter(nudged[0], np.float32(2.0))
    out["port one device, frame 0 one f32 ulp up, f64"] = float((_run(nudged, _seeded(torch.float64)) - ref).abs().max())
    rng = np.random.default_rng(91)
    f0, f1 = (torch.from_numpy(rng.random((2, 64, 64, 3), np.float32)) for _ in range(2))
    t = torch.full((2,), 0.5)
    one = _seeded(torch.float32)(CPU)(f0, f1, t)
    two = parallel.make_sharded_model_fn(_seeded(torch.float32), parallel.make_mesh(2, shape=(2, 1), devices=_replicas(2)))(f0, f1, t)
    out["data split (2, 1) vs one device, f32"] = float((two - one).abs().max())
    per = torch.cat([_seeded(torch.float32)(CPU)(f0[i : i + 1], f1[i : i + 1], t[:1], batch_slice=(i, 2)) for i in range(2)])
    out["one device at batch 2 vs two batch-1 calls on the same noise, f32"] = float((per - one).abs().max())
    return out


if __name__ == "__main__":
    for k, v in _gaps().items():
        print(k, v, flush=True)
