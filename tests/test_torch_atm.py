"""The port's ATM-VFI against the JAX package's, on the CPU, with the same
weights (the port's numpy ``init_params`` carried across by
``nest_state_dict``) and the same numpy inputs.

* ``state_dict`` keys and shapes equal the ``atm-vfi-lite.pt`` manifest (236
  tensors); base has the keys the JAX ``apply`` reads; seeding is
  deterministic and every ``relative_coord`` holds the coordinates.
* The window masks (padding, shift, both) and the relative coordinates equal
  JAX's exactly; the window partition is batch-major and row-major.
* ``ATMFormer`` and ``RefineBottleneck`` on two different frames' 12x20 map
  (padded centred to 16x24: 6 windows of 8), with and without shift, against
  JAX's ``_atmformer`` / ``_refine_bottleneck`` within 1e-5 of the
  magnitude; frames swapped, the motion follows the swap.
* The global-motion ensemble's three photometric losses within 1e-5 of JAX's
  and the same chosen scale per sample, on inputs whose losses lie well
  apart.
* ``make_model_fn`` end to end on the demo frames every fourth pixel, 60x180
  (edge-padded to 64x192 inside, centred; 3 local windows at 1/8, the
  global ones padded), base and lite with global motion on and off and base
  with the ensemble: fp32 within 1e-4 of JAX fp32; bf16 >= 40 dB against
  JAX fp32 (the ensemble in fp32 only: its per-sample ``argmin`` may pick
  another scale in bf16).
* ``warps_per_forward`` equals the warps a forward makes, the enhanced
  features' two halves as channel slices of one tensor.
* The JAX golden (``tests/fixtures/torch_port_atm_golden.npz``: the demo
  frames every fourth pixel cropped to 64x192, base with global motion,
  weights from the seed) is regenerated with JAX and must be unchanged; the
  port matches it at >= 40 dB.

The JAX model runs go through one jitted function with the weights as an
argument, one compile per variant and shape, shared by the model, ensemble
and golden tests. Run ``python tests/test_torch_atm.py`` to rewrite the
fixture.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.models import atm as ja
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch.models import atm as pa
from comfyui_frame_interpolation_tpu_torch.ops.cuda import warp_kernel
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "torch_port_atm_golden.npz")
GOLDEN_SEED = 2027
HW = (64, 192)  # the padded size of the model tests and the golden


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def _close(got, ref, what, tol):
    ref, got = np.asarray(ref), np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= tol * (1.0 + np.abs(ref).max()), (what, err)


def _jax_params(sd):
    return to_jax_tree(nest_state_dict(sd))


# ---- a. layout and weights -------------------------------------------------------


def test_state_dict_equals_the_manifest():
    with open(os.path.join(ROOT, "tests", "fixtures", "ckpt_manifests.json")) as f:
        want = json.load(f)["manifests"]["atm-vfi-lite.pt"]["tensors"]
    lite = pa.init_params("lite", 0)
    assert {k: list(v.shape) for k, v in lite.items()} == want and len(lite) == 236
    base = pa.init_params("base", 0)
    assert set(base) == set(lite)
    assert tuple(base["feat_enhance_transformer.0.attn.qkv.weight"].shape) == (1152, 384)
    assert tuple(base["global_motion_mlp.0.0.weight"].shape) == (768, 8 + 2 * 672, 3, 3)
    assert tuple(base["local_motion_atmformer.0.attn.mlp.0.weight"].shape) == (6, 8)
    assert tuple(base["upsample_pyramid.0.0.0.weight"].shape) == (773, 389, 2, 2)
    assert tuple(base["proj.0.weight"].shape) == (48, 101 + 15, 3, 3)


def test_init_params_is_seeded():
    a, b, c = pa.init_params("lite", 0), pa.init_params("lite", 0), pa.init_params("lite", 1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["proj.0.weight"], c["proj.0.weight"])
    assert torch.equal(a["proj.1.weight"], torch.full((32,), 0.25))
    for key, window in (("local_motion_atmformer.1.attn.relative_coord", 8), ("global_motion_atmformer.0.attn.relative_coord", 12)):
        np.testing.assert_array_equal(a[key][0, 0].numpy(), ja._relative_coord(window))


# ---- b. windows, masks and the two attention blocks ------------------------------


@pytest.mark.parametrize("h,w,window,shift", [(12, 20, 8, 0), (12, 20, 8, 4), (16, 24, 8, 4), (8, 12, 12, 6), (68, 120, 12, 0)])
def test_masks_equal_jax(h, w, window, shift):
    got, ref = pa._attn_masks(h, w, window, shift), ja._attn_masks(h, w, window, shift)
    assert (got is None) == (ref is None)
    if ref is not None:
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_relative_coord_and_partition_order():
    for ws in (8, 12):
        np.testing.assert_array_equal(pa._relative_coord(ws), ja._relative_coord(ws))
    x = np.arange(2 * 16 * 24 * 3, dtype=np.float32).reshape(2, 16, 24, 3)
    got = pa._window_partition(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ja._window_partition(jnp.asarray(x), (8, 8))))
    np.testing.assert_array_equal(got[1].numpy(), x[0, :8, 8:16].reshape(64, 3))  # window 1: row 0, column 1
    np.testing.assert_array_equal(got[6].numpy(), x[1, :8, :8].reshape(64, 3))  # frame 1's first window
    np.testing.assert_array_equal(pa._window_reverse(got, 8, 16, 24).numpy(), x)


def _block(cls, seed, *args):
    with torch.device("meta"):
        m = cls(*args)
    sd = pa.init_state_dict(m, seed)
    for key in sd:
        if key.endswith("relative_coord"):
            sd[key] = torch.from_numpy(pa._relative_coord(args[1]))[None, None]
    m = cls(*args)
    m.load_state_dict(sd)
    return m.eval(), _jax_params(sd)


def _two_frames(seed, c, h=12, w=20):
    """Two different frames' maps, ``[2, h, w, c]``: a smooth shifted pattern
    and noise, so that each frame's windows differ."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    freq = rng.uniform(0.2, 0.6, (c, 2))
    f0 = np.sin(freq[:, 0] * xx[..., None] + freq[:, 1] * yy[..., None])
    f1 = np.sin(freq[:, 0] * (xx[..., None] - 2) + freq[:, 1] * (yy[..., None] + 1))
    return (np.stack([f0, f1]) + 0.3 * rng.standard_normal((2, h, w, c))).astype(np.float32)


@pytest.mark.parametrize("shift", [0, 4])
def test_atmformer_matches_jax_on_a_padded_map(shift):
    """12x20 tokens pad to 16x24: 6 windows per frame, centred padding masked."""
    m, p = _block(pa.ATMFormer, 3, 32, 8, 2.0, 4)
    x = _two_frames(1, 32)
    ref_x, ref_m = jax.jit(ja._atmformer, static_argnums=(2, 3))(p, jnp.asarray(x), 8, shift)
    with torch.no_grad():
        got_x, got_m = m(torch.from_numpy(x), shift)
    _close(got_x.reshape(2, -1, 32).numpy(), ref_x, "tokens", 1e-5)
    _close(got_m.reshape(2, -1, 2).numpy(), ref_m, "motion", 1e-5)
    with torch.no_grad():  # frames swapped: each frame's result moves with it
        sx, sm = m(torch.from_numpy(x[::-1].copy()), shift)
    torch.testing.assert_close(sx, got_x.flip(0), atol=1e-5, rtol=0)
    torch.testing.assert_close(sm, got_m.flip(0), atol=1e-5, rtol=0)


@pytest.mark.parametrize("shift", [0, 4])
def test_refine_bottleneck_matches_jax_on_a_padded_map(shift):
    m, p = _block(pa.RefineBottleneck, 4, 32, 8, 2.0)
    x = _two_frames(2, 32)
    ref = jax.jit(ja._refine_bottleneck, static_argnums=(2, 3))(p, jnp.asarray(x), 8, shift)
    with torch.no_grad():
        got = m(torch.from_numpy(x), shift)
    _close(got.reshape(2, -1, 32).numpy(), ref, "bottleneck", 1e-5)


# ---- c. the model function -----------------------------------------------------------


def _demo_frames():
    """``anime0.png`` and ``anime1.png`` every fourth pixel, cropped to
    64x192, uint8 ``[2, 1, 64, 192, 3]``."""
    from PIL import Image

    imgs = [np.asarray(Image.open(os.path.join(ROOT, "demo_frames", f"anime{i}.png")).convert("RGB")) for i in (0, 1)]
    return np.stack(imgs)[:, None, ::4, ::4][:, :, 36:100, 24:216]


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _jax_fn(p, f0, f1, variant, global_motion, ensemble):
    out = ja.apply(p, f0, f1, None, variant=variant, global_motion=global_motion, ensemble_global_motion=ensemble)
    if not ensemble:
        return out, None
    losses = []  # the ensemble's losses, as its loop takes them
    im = jnp.concatenate([f0, f1])
    for lvl in range(3):
        if lvl:
            im = ja.resize_by_scale(im, 0.5, align_corners=True)
        feat_, levels = ja._feat_extract(p, im)
        g0, g1, _ = ja._estimate_global_motion(p, feat_, levels)
        losses.append(ja._global_alignmentness(g0, g1, f0, f1))
    return out, jnp.stack(losses)


def _model_inputs():
    """Two pairs cropped to 60x180: the demo pair, and a demo frame and its
    copy shifted by (6, 3) pixels."""
    demo = _demo_frames()[:, 0].astype(np.float32) / 255.0
    shifted = np.roll(demo[0], (3, 6), (0, 1))
    return (np.ascontiguousarray(np.stack(f)[:, 2:62, 6:186]) for f in ((demo[0], demo[1]), (demo[1], shifted)))


def _edge_pad(f):
    """60x180 -> 64x192, edge mode, centred: the padding ``make_model_fn`` gives."""
    return np.pad(f, ((0, 0), (2, 2), (6, 6), (0, 0)), mode="edge")


@functools.lru_cache(maxsize=None)
def _jax_run(variant, global_motion, ensemble, seed=0):
    """JAX on the edge-padded pairs; the output cropped back to 60x180."""
    f0, f1 = _model_inputs()
    sd = pa.init_params(variant, seed)
    out, losses = _jax_fn(_jax_params(sd), jnp.asarray(_edge_pad(f0)), jnp.asarray(_edge_pad(f1)), variant, global_motion, ensemble)
    return f0, f1, sd, np.asarray(out)[:, 2:62, 6:186], None if losses is None else np.asarray(losses)


CASES = [("base", True, False), ("base", False, False), ("lite", True, False), ("lite", False, False), ("base", True, True)]


@pytest.mark.parametrize("variant,global_motion,ensemble", CASES)
def test_make_model_fn_matches_jax_fp32_and_bf16(variant, global_motion, ensemble):
    """The port's ``make_model_fn`` edge-pads the 60x180 frames to 64x192,
    centred, as JAX's input was padded."""
    f0, f1, sd, want, _ = _jax_run(variant, global_motion, ensemble)
    x0, x1 = torch.from_numpy(f0), torch.from_numpy(f1)
    got = pa.make_model_fn(sd, variant, global_motion, ensemble, device="cpu")(x0, x1, torch.tensor([0.5, 0.5]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 60, 180, 3)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4
    if not ensemble:
        got16 = pa.make_model_fn(sd, variant, global_motion, ensemble, dtype=torch.bfloat16, device="cpu")(x0, x1)
        assert psnr(got16.numpy(), want) >= 40.0


def test_ensemble_losses_and_choice_match_jax():
    f0, f1, sd, _, want = _jax_run("base", True, True)
    net = pa._load(sd, "base", torch.float32, "cpu")
    with torch.no_grad():
        _, got = pa._multiscale_global_ensemble(net, *(torch.from_numpy(_edge_pad(f)).permute(0, 3, 1, 2) for f in (f0, f1)))
    _close(got.numpy(), want, "losses", 1e-5)
    gaps = np.sort(want, 0)[1] - np.sort(want, 0)[0]
    assert gaps.min() > 1e-3 * want.max(), "inputs whose losses lie well apart"
    np.testing.assert_array_equal(got.argmin(0).numpy(), want.argmin(0))


@pytest.mark.parametrize("variant,global_motion,ensemble,dtype", [
    ("base", True, False, torch.bfloat16), ("base", False, False, torch.float32), ("lite", True, False, torch.bfloat16),
    ("base", True, True, torch.float32),
])
def test_launch_counts_equal_a_forward(variant, global_motion, ensemble, dtype, monkeypatch):
    """The warps of one forward, routed by their planes as the card would
    route them, against ``warps_per_forward``; the fused features' and the
    enhanced halves' strides as the model gives them."""
    seen = []
    real = pa.warp

    def spy(img, flow, *args):
        planes = img.permute(0, 3, 1, 2)
        seen.append((warp_kernel.route(planes.shape, planes.stride(), planes.dtype), tuple(img.shape), img.stride()))
        return real(img, flow, *args)

    monkeypatch.setattr(pa, "warp", spy)
    f = [torch.rand(1, *HW, 3, generator=torch.Generator().manual_seed(i)) for i in range(2)]
    pa.make_model_fn(pa.init_params(variant, 0), variant, global_motion, ensemble, dtype=dtype, device="cpu")(*f)
    counts = {"narrow": sum(r == "tiled" for r, _, _ in seen), "wide": sum(r == "wide" for r, _, _ in seen)}
    assert counts == pa.warps_per_forward(variant, global_motion, ensemble, dtype)
    fd = pa.fused_dim(variant)
    assert counts == {"narrow": (6 if global_motion else 0) + (6 if ensemble else 0) + 6, "wide": 4 if global_motion else 2}
    halves = [s for r, shape, s in seen if shape == (1, 8, 24, fd)][-2:]
    assert halves == [(8 * 24 * 2 * fd, 24 * 2 * fd, 2 * fd, 1)] * 2  # channel slices of [1, 8, 24, 2 fd]


# ---- d. the golden ----------------------------------------------------------------------------


def make_golden(seed=GOLDEN_SEED):
    """JAX ATM base fp32 with global motion on the demo pair every fourth
    pixel cropped to 64x192, weights ``init_params("base", seed)``."""
    assert seed == GOLDEN_SEED
    frames = _demo_frames().astype(np.float32) / 255.0
    out, _ = _jax_fn(_jax_params(pa.init_params("base", seed)), jnp.asarray(frames[0]), jnp.asarray(frames[1]), "base", True, False)
    return _demo_frames(), np.asarray(out)


def test_golden_fixture_is_current_and_port_matches_it():
    with np.load(GOLDEN) as z:
        seed, frames, stored = int(z["seed"]), z["frames"], z["output"]
    assert seed == GOLDEN_SEED and stored.shape == (1, *HW, 3)
    np.testing.assert_array_equal(frames, _demo_frames())
    np.testing.assert_allclose(make_golden(seed)[1], stored, atol=1e-6, rtol=0)
    f0, f1 = (torch.from_numpy(frames[i].astype(np.float32) / 255.0) for i in (0, 1))
    got = pa.make_model_fn(pa.init_params("base", seed), "base", device="cpu")(f0, f1)
    assert psnr(got.numpy(), stored) >= 40.0
    assert float(np.abs(got.numpy() - stored).max()) <= 1e-4


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    frames, out = make_golden(GOLDEN_SEED)
    np.savez_compressed(GOLDEN, seed=np.int64(GOLDEN_SEED), frames=frames, output=out)
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
