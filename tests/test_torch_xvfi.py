"""The port's XVFI against the JAX package's, on the CPU, with the same weights
(the port's numpy ``init_params`` carried across by ``nest_state_dict``) and
the same numpy inputs.

* ``state_dict`` keys and shapes equal the ``XVFInet_Vimeo_exp1_latest.pt``
  manifest (72 tensors); X4K has the reference's keys at scale 4; every
  aliased key (``rec_ext_ds`` at indices 1 and 3 of ``rec_ext_ds_module``,
  ``channel_converter`` at index 0) holds one tensor; seeding is
  deterministic.
* The feature pyramid (Vimeo and X4K) within 1e-5 of the magnitude.
* ``_bwarp`` in f32 within 1e-6 and the same pixels masked, for 64-channel
  features and frames; the known bf16 difference shown: JAX compares its
  bf16 ones with 0.999, which rounds to 1.0, so it keeps a pixel whose ones
  are 0.9985 (rounded to 1.0) that f32 masks.
* ``_z_fwarp`` in f32 within 1e-5 of the largest output, sums and
  normalisation.
* The model end to end in fp32 within 1e-4 of JAX fp32 and bf16 >= 40 dB
  against it: Vimeo through ``make_pair_fns`` (two pairs of 60x180, padded
  to 64x192 inside, t per sample) and ``make_model_fn``; X4K (scale 4)
  through ``apply`` with ``S_tst`` 2 at 64x192 (the node's S_tst of 5 pads
  to 512: ``tests/test_torch_node.py`` runs it).
* ``warps_per_reuse``, ``warps_per_infer`` and ``splats_per_infer`` equal the
  launches a reuse and an infer make, for Vimeo and X4K.
* The JAX golden (``tests/fixtures/torch_port_xvfi_golden.npz``: the demo
  pair every fourth pixel cropped to 64x192, Vimeo, t = 0.5, weights from
  the seed) is regenerated with JAX and must be unchanged; the port matches
  it at >= 40 dB.

The JAX model runs go through one jitted ``apply`` with the weights as an
argument, one compile per configuration, shared by the model and golden
tests. Run ``python tests/test_torch_xvfi.py`` to rewrite the fixture.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.models import xvfi as jx
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch.models import xvfi as px
from comfyui_frame_interpolation_tpu_torch.ops.cuda import warp_kernel
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "torch_port_xvfi_golden.npz")
GOLDEN_SEED = 2028
VIMEO = "XVFInet_Vimeo_exp1_latest.pt"
X4K = "XVFInet_X4K1000FPS_exp1_latest.pt"
HW = (64, 192)


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def _close(got, ref, what, tol):
    ref, got = np.asarray(ref), np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= tol * (1.0 + np.abs(ref).max()), (what, err)


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


def _jax_params(sd):
    return to_jax_tree(nest_state_dict(sd))


# ---- a. layout and weights -------------------------------------------------------


def test_state_dict_equals_the_manifest_and_aliases_share_a_tensor():
    with open(os.path.join(ROOT, "tests", "fixtures", "ckpt_manifests.json")) as f:
        want = json.load(f)["manifests"][VIMEO]["tensors"]
    vimeo = px.init_params(VIMEO, 0)
    assert {k: list(v.shape) for k, v in vimeo.items()} == want and len(vimeo) == 72
    assert vimeo["rec_ext_ds_module.1.weight"] is vimeo["rec_ext_ds.weight"]
    assert vimeo["rec_ext_ds_module.0.0.bias"] is vimeo["channel_converter.0.bias"]
    assert not torch.equal(vimeo["rec_ext_ds_module.3.weight"], vimeo["rec_ext_ds.weight"])  # its own conv
    x4k = px.init_params(X4K, 0)
    for k in ("weight", "bias"):
        assert x4k[f"rec_ext_ds_module.1.{k}"] is x4k[f"rec_ext_ds_module.3.{k}"] is x4k[f"rec_ext_ds.{k}"]
    assert "rec_ext_ds_module.6.resblock2.conv3x3_2.weight" in x4k and tuple(x4k["vfinet.refine_unet.enc1.weight"].shape) == (64, 32, 4, 4)
    assert len(x4k) == 74  # Vimeo's 72, index 3 now an alias, and 5 and 6 (8 tensors) in place of 3 and 4


def test_init_params_is_seeded():
    a, b, c = px.init_params(VIMEO, 0), px.init_params(VIMEO, 0), px.init_params(VIMEO, 1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["vfinet.conv_flow1.weight"], c["vfinet.conv_flow1.weight"])


# ---- b. the pyramid and the two warps ----------------------------------------------


@pytest.mark.parametrize("ckpt,s_tst", [(VIMEO, 1), (X4K, 2)])
def test_feat_pyramid_matches_jax(ckpt, s_tst):
    sd = px.init_params(ckpt, 3)
    scale = px.CKPT_CONFIGS[ckpt]["module_scale_factor"]
    x = np.random.default_rng(1).random((4, 32, 48, 3), dtype=np.float32)
    ref = jx.feat_pyramid(_jax_params(sd), jnp.asarray(x), scale, s_tst)
    with torch.no_grad():
        got = px.feat_pyramid(px._load(sd, scale, torch.float32, "cpu"), _nchw(x), s_tst)
    assert len(got) == len(ref) == s_tst + 1
    for lvl, (g, r) in enumerate(zip(got, ref)):
        _close(_nhwc(g), r, f"level {lvl}", 1e-5)


def _warp_case(c, seed):
    """Values and a flow that moves some pixels off the frame and leaves the
    left column's pixel (2, 0) a hair outside (ones 0.9985)."""
    rng = np.random.default_rng(seed)
    x = rng.random((2, 13, 19, c), dtype=np.float32) + 0.5
    yy, xx = np.mgrid[0:13, 0:19].astype(np.float32)
    flow = np.stack([3.5 * np.sin(0.4 * yy + 0.2 * xx), 2.5 * np.cos(0.3 * xx - 0.1 * yy)], -1)[None].repeat(2, 0)
    flow[:, 2, 0] = (-0.0015, 0.0)
    return x, flow


@pytest.mark.parametrize("c", [64, 3])
def test_bwarp_matches_jax_f32(c):
    x, flow = _warp_case(c, 5)
    ref = np.asarray(jx._bwarp(jnp.asarray(x), jnp.asarray(flow)))
    got = _nhwc(px._bwarp(_nchw(x), torch.from_numpy(flow).permute(0, 3, 1, 2)))
    np.testing.assert_array_equal(got == 0.0, ref == 0.0)  # the same pixels masked
    assert (ref == 0.0).any() and (ref != 0.0).any() and (ref[:, 2, 0] == 0.0).all()
    _close(got, ref, "bwarp", 1e-6)


def test_jax_bf16_mask_keeps_what_f32_masks():
    """The known difference (``ROADMAP.md`` Queue 3): pixel (2, 0) warps its
    ones to 0.9985. The port masks it in every dtype (its ones are f32), as
    JAX does in f32; JAX in bf16 rounds 0.9985 to 1.0 and the threshold
    0.999 to 1.0, and keeps it."""
    x, flow = _warp_case(64, 6)
    j16 = np.asarray(jx._bwarp(jnp.asarray(x, jnp.bfloat16), jnp.asarray(flow)).astype(jnp.float32))
    p16 = _nhwc(px._bwarp(_nchw(x).bfloat16(), torch.from_numpy(flow).permute(0, 3, 1, 2)))
    assert (p16[:, 2, 0] == 0.0).all() and (j16[:, 2, 0] != 0.0).all()
    differ = (p16 == 0.0) != (j16 == 0.0)
    print(f"JAX bf16 keeps {int(differ.any(-1).sum())} pixels that the port masks, of {differ.shape[0] * 13 * 19}")
    assert ((p16 == 0.0) | ~differ).all()  # the port masks a superset


def test_z_fwarp_matches_jax_f32():
    rng = np.random.default_rng(7)
    img = rng.standard_normal((2, 16, 24, 2)).astype(np.float32) * 3.0
    flow = rng.standard_normal((2, 16, 24, 2)).astype(np.float32) * 4.0
    z = rng.standard_normal((2, 16, 24, 1)).astype(np.float32)
    ref_sum, ref_norm = (np.asarray(r) for r in jx._z_fwarp(jnp.asarray(img), jnp.asarray(flow), jax.nn.sigmoid(jnp.asarray(z))))
    got_sum, got_norm = px._z_fwarp(*(torch.from_numpy(a).permute(0, 3, 1, 2) for a in (img, flow)),
                                    torch.sigmoid(torch.from_numpy(z).permute(0, 3, 1, 2)))
    assert got_sum.dtype == got_norm.dtype == torch.float32
    for g, r, what in ((got_sum, ref_sum, "sums"), (got_norm, ref_norm, "norm")):
        err = np.abs(_nhwc(g) - r).max()
        assert err <= 1e-5 * np.abs(r).max(), (what, err)


# ---- c. the model ----------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jax_apply(p, f0, f1, t, scale, s_tst):
    return jx.apply(p, f0, f1, t, module_scale_factor=scale, s_tst=s_tst)


def _demo_frames():
    """``anime0.png`` and ``anime1.png`` every fourth pixel, cropped to
    64x192, uint8 ``[2, 1, 64, 192, 3]``."""
    from PIL import Image

    imgs = [np.asarray(Image.open(os.path.join(ROOT, "demo_frames", f"anime{i}.png")).convert("RGB")) for i in (0, 1)]
    return np.stack(imgs)[:, None, ::4, ::4][:, :, 36:100, 24:216]


def _pairs():
    """Two pairs of 64x192: the demo pair, and a demo frame and its copy
    shifted by (6, 3) pixels."""
    demo = _demo_frames()[:, 0].astype(np.float32) / 255.0
    shifted = np.roll(demo[0], (3, 6), (0, 1))
    return np.stack([demo[0], demo[1]]), np.stack([demo[1], shifted])


T = np.asarray([0.3, 0.7], np.float32)


@functools.lru_cache(maxsize=None)
def _jax_run(ckpt, s_tst, seed=0):
    f0, f1 = _pairs()
    sd = px.init_params(ckpt, seed)
    scale = px.CKPT_CONFIGS[ckpt]["module_scale_factor"]
    out = _jax_apply(_jax_params(sd), jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(T), scale, s_tst)
    return f0, f1, sd, np.asarray(out)


def test_vimeo_pair_fns_match_jax_fp32_and_bf16():
    """The frames cropped to 60x180 take the zero pad at the bottom and right
    back to 64x192; JAX ran on the frames with that zero border."""
    f0, f1, sd, _ = _jax_run(VIMEO, 1)
    z0, z1 = (f.copy() for f in (f0, f1))
    for z in (z0, z1):
        z[:, 60:], z[:, :, 180:] = 0.0, 0.0
    want = np.asarray(_jax_apply(_jax_params(sd), jnp.asarray(z0), jnp.asarray(z1), jnp.asarray(T), 2, 1))[:, :60, :180]
    x0, x1 = (torch.from_numpy(np.ascontiguousarray(f[:, :60, :180])) for f in (f0, f1))
    for dtype in (torch.float32, torch.bfloat16):
        reuse, infer = px.make_pair_fns(sd, VIMEO, dtype=dtype, device="cpu")
        cache = reuse(x0, x1)
        outs = [infer(x0, x1, cache, torch.from_numpy(t)) for t in (T, T[::-1].copy())]
        assert outs[0].dtype == torch.float32 and tuple(outs[0].shape) == (2, 60, 180, 3)
        if dtype == torch.float32:
            assert float(np.abs(outs[0].numpy() - want).max()) <= 1e-4
            model = px.make_model_fn(sd, VIMEO, device="cpu")(x0, x1, torch.from_numpy(T))
            torch.testing.assert_close(model, outs[0], atol=1e-5, rtol=0)
        else:
            assert psnr(outs[0].numpy(), want) >= 40.0
        assert not torch.equal(outs[0], outs[1])  # the timestep reaches the synthesis


@pytest.mark.parametrize("ckpt,s_tst", [(VIMEO, 1), (X4K, 2)])
def test_apply_matches_jax_fp32_and_bf16(ckpt, s_tst):
    f0, f1, sd, want = _jax_run(ckpt, s_tst)
    scale = px.CKPT_CONFIGS[ckpt]["module_scale_factor"]
    for dtype in (torch.float32, torch.bfloat16):
        net = px._load(sd, scale, dtype, "cpu")
        with torch.no_grad():
            got = px.apply(net, *(torch.from_numpy(f).to(dtype) for f in (f0, f1)), torch.from_numpy(T), s_tst)
        assert got.dtype == torch.float32 and tuple(got.shape) == (2, *HW, 3)
        if dtype == torch.float32:
            assert float(np.abs(got.numpy() - want).max()) <= 1e-4
        else:
            assert psnr(got.numpy(), want) >= 40.0


@pytest.mark.parametrize("ckpt,dtype", [(VIMEO, torch.bfloat16), (VIMEO, torch.float32), (X4K, torch.bfloat16)])
def test_launch_counts_equal_a_reuse_and_an_infer(ckpt, dtype, monkeypatch):
    """Each warp and splat of a reuse and an infer, routed by its planes as
    the card would route it, against ``warps_per_reuse``,
    ``warps_per_infer`` and ``splats_per_infer``: the features at 1/scale
    (and coarser) on the wide kernel, frames and f32 ones planes on K1, one
    f32 splat of ``[2B, h, w, 3]``."""
    seen, splats = [], []
    real_warp, real_splat = px.warp, px.softsplat_func

    def warp_spy(img, flow, *args):
        planes = img.permute(0, 3, 1, 2)
        seen.append((warp_kernel.route(planes.shape, planes.stride(), planes.dtype), tuple(img.shape), img.dtype))
        return real_warp(img, flow, *args)

    def splat_spy(x, flow):
        splats.append((tuple(x.shape), x.dtype))
        return real_splat(x, flow)

    monkeypatch.setattr(px, "warp", warp_spy)
    monkeypatch.setattr(px, "softsplat_func", splat_spy)
    f = [torch.rand(1, 48, 80, 3, generator=torch.Generator().manual_seed(i)) for i in range(2)]
    reuse, infer = px.make_pair_fns(px.init_params(ckpt, 0), ckpt, dtype=dtype, device="cpu")
    cache = reuse(*f)

    def counts():
        return {"narrow": sum(r == "tiled" for r, _, _ in seen), "wide": sum(r == "wide" for r, _, _ in seen)}

    assert counts() == px.warps_per_reuse(ckpt, dtype) and not splats
    seen.clear()
    infer(*f, cache, torch.tensor([0.5]))
    assert counts() == px.warps_per_infer(dtype) == {"narrow": 8, "wide": 4}
    assert len(splats) == px.splats_per_infer() == 1
    cfg = px.CKPT_CONFIGS[ckpt]
    d, scale = px._divide(cfg), cfg["module_scale_factor"]
    h, w = cache[0].shape[2:]
    assert splats == [((2, h, w, 3), torch.float32)] and (h, w) == (-(-48 // d) * d // scale, -(-80 // d) * d // scale)
    assert sum(s == (1, h, w, 64) and dt == dtype for _, s, dt in seen) == 4
    assert sum(s[-1] == 1 and dt == torch.float32 for _, s, dt in seen) == 6
    if ckpt == X4K:
        assert px.warps_per_reuse(ckpt, dtype) == {"narrow": 10, "wide": 10}


# ---- d. the golden ----------------------------------------------------------------------------


def make_golden(seed=GOLDEN_SEED):
    """JAX XVFI Vimeo fp32 at t = 0.5 on the demo pair every fourth pixel
    cropped to 64x192, weights ``init_params(VIMEO, seed)``."""
    assert seed == GOLDEN_SEED
    f0, f1 = _pairs()  # the demo pair first: the compile of the model tests
    out = _jax_apply(_jax_params(px.init_params(VIMEO, seed)), jnp.asarray(f0), jnp.asarray(f1), jnp.full((2,), 0.5), 2, 1)
    return _demo_frames(), np.asarray(out)[:1]


def test_golden_fixture_is_current_and_port_matches_it():
    with np.load(GOLDEN) as z:
        seed, t, frames, stored = int(z["seed"]), float(z["t"]), z["frames"], z["output"]
    assert seed == GOLDEN_SEED and t == 0.5 and stored.shape == (1, *HW, 3)
    np.testing.assert_array_equal(frames, _demo_frames())
    np.testing.assert_allclose(make_golden(seed)[1], stored, atol=1e-6, rtol=0)
    f0, f1 = (torch.from_numpy(frames[i].astype(np.float32) / 255.0) for i in (0, 1))
    got = px.make_model_fn(px.init_params(VIMEO, seed), VIMEO, device="cpu")(f0, f1, torch.tensor([t]))
    assert psnr(got.numpy(), stored) >= 40.0
    assert float(np.abs(got.numpy() - stored).max()) <= 1e-4


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    frames, out = make_golden(GOLDEN_SEED)
    np.savez_compressed(GOLDEN, seed=np.int64(GOLDEN_SEED), t=np.float32(0.5), frames=frames, output=out)
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
