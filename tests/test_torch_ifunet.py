"""The port's IFUnet against the JAX package's, on the CPU, with the same weights
(the port's numpy ``init_params`` carried across by ``nest_state_dict``) and
the same numpy inputs.

* ``state_dict`` keys and shapes equal the ``IFUNet.pth`` manifest (608
  tensors); seeding is deterministic; batch norms start at the identity.
* Per module, with the batch norms' running statistics perturbed so that
  they act: CBAM within 1e-5 of the magnitude; the flow block's convex
  upsampling at x16, x8 and x4, and resized by 0.5 after, within 1e-5 of the
  magnitude; the feature net on a 17-channel input (its ``conv0`` skipped,
  a shape test) and on a 7-channel one, within 2e-5 of the magnitude.
* ``make_model_fn`` end to end on the demo frames every eighth pixel (68x120,
  padded to 128x128 inside), with and without the ensemble: fp32 within 1e-4
  of JAX fp32, bf16 >= 40 dB against JAX fp32.
* ``warps_per_forward`` equals the warps a forward makes, with and without
  the ensemble (12 K1, 2 wide).
* The JAX golden (``tests/fixtures/torch_port_ifunet_golden.npz``: the demo
  frames every eighth pixel, no ensemble, t = 0.5, weights from the seed) is
  regenerated with JAX and must be unchanged; the port matches it at >= 40 dB.

The model runs go through one jitted function with the weights as an
argument, compiled once per ensemble setting at the golden's shape. Run
``python tests/test_torch_ifunet.py`` to rewrite the fixture.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.models import ifunet as ju
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch.models import ifrnet as pi
from comfyui_frame_interpolation_tpu_torch.models import ifunet as pu
from comfyui_frame_interpolation_tpu_torch.ops.cuda import warp_kernel
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "torch_port_ifunet_golden.npz")
GOLDEN_SEED = 2025


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


@functools.lru_cache(maxsize=None)
def _params(which):
    """``init_params(0)`` with each batch norm's running statistics drawn
    away from the identity ("perturbed"), or ``init_params(GOLDEN_SEED)``."""
    if which == "golden":
        sd = pu.init_params(GOLDEN_SEED)
    else:
        sd = pu.init_params(0)
        rng = np.random.default_rng(100)
        for k, v in sd.items():
            if k.endswith("running_mean"):
                sd[k] = torch.from_numpy(rng.uniform(-0.2, 0.2, v.shape).astype(np.float32))
            elif k.endswith("running_var"):
                sd[k] = torch.from_numpy(rng.uniform(0.8, 1.2, v.shape).astype(np.float32))
    return sd, to_jax_tree(nest_state_dict(sd))


@functools.lru_cache(maxsize=None)
def _net():
    return pu._load(_params("perturbed")[0], torch.float32, "cpu")


# ---- a. layout and weights -------------------------------------------------------


def test_state_dict_equals_the_manifest():
    with open(os.path.join(ROOT, "tests", "fixtures", "ckpt_manifests.json")) as f:
        want = json.load(f)["manifests"]["IFUNet.pth"]["tensors"]
    params = pu.init_params(0)
    assert {k: list(v.shape) for k, v in params.items()} == want and len(params) == 608


def test_init_params_is_seeded_and_norms_start_at_identity():
    a, b, c = pu.init_params(0), pu.init_params(0), pu.init_params(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["flownet.block0.maskconvx16.weight"], c["flownet.block0.maskconvx16.weight"])
    assert torch.equal(a["refinenet.block0.conv0.0.1.running_var"], torch.ones(64))
    assert torch.equal(a["flownet.fmap.conv2.cbam.SpatialGate.spatial.bn.running_mean"], torch.zeros(1))
    assert a["refinenet.block2.convblock.5.1.num_batches_tracked"].dtype == torch.int64


# ---- b. the modules ----------------------------------------------------------------


def test_cbam():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 9, 64)).astype(np.float32)
    jp = _params("perturbed")[1]["flownet"]["fmap"]["conv2"]["cbam"]
    ref = jax.jit(ju._cbam)(jp, jnp.asarray(x))
    with torch.inference_mode():
        got = _net().flownet.fmap.conv2.cbam(_nchw(x))
    _close(_nhwc(got), ref, "cbam", 1e-5)


@pytest.mark.parametrize("level", [16, 8, 4])
@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_convex_upsampling(level, scale):
    """Block 2 (C = 64) at each of its mask convs: the 9 zero-padded
    neighbours (the frame's edge pixels among them), the softmax over the
    taps and the pixel shuffle, then the resize that follows for
    ``scale`` != 1."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 5, 64)).astype(np.float32)
    ref = ju._if_block(_params("perturbed")[1]["flownet"]["block2"], jnp.asarray(x), level, scale)
    with torch.inference_mode():
        got = _net().flownet.block2(_nchw(x), level, scale)
    assert tuple(got.shape) == (2, 4, int(3 * level * scale), int(5 * level * scale))
    _close(_nhwc(got), ref, f"convex upsampling x{level}", 1e-5)


@pytest.mark.parametrize("channels,level", [(17, 1), (7, 0)])
def test_feature_net(channels, level):
    """17 input channels skip ``conv0`` (the later blocks' input); 7 take
    it (the first block's)."""
    rng = np.random.default_rng(3)
    x = rng.random((1, 64, 64, channels), dtype=np.float32)
    ref = jax.jit(ju._feature_net, static_argnums=(2,))(_params("perturbed")[1]["flownet"]["fmap"], jnp.asarray(x), level)
    with torch.inference_mode():
        got = _net().flownet.fmap(_nchw(x), level)
    _close(_nhwc(got), ref, f"feature net C={channels}", 2e-5)


# ---- c. the model function -----------------------------------------------------------


def _demo_frames():
    """``anime0.png`` and ``anime1.png`` every eighth pixel, uint8 ``[2, 1,
    68, 120, 3]``."""
    from PIL import Image

    imgs = [np.asarray(Image.open(os.path.join(ROOT, "demo_frames", f"anime{i}.png")).convert("RGB")) for i in (0, 1)]
    return np.stack(imgs)[:, None, ::8, ::8]


@functools.partial(jax.jit, static_argnums=(4,))
def _jax_fn(p, f0, f1, t, ensemble):
    return ju.apply(p, f0, f1, t, ensemble=ensemble)


@functools.lru_cache(maxsize=None)
def _jax_run(which, ensemble, t):
    frames = _demo_frames().astype(np.float32) / 255.0
    t = np.asarray([t], np.float32)
    out = _jax_fn(_params(which)[1], jnp.asarray(frames[0]), jnp.asarray(frames[1]), jnp.asarray(t), ensemble)
    return frames, t, np.asarray(out)


@pytest.mark.parametrize("ensemble", [False, True])
def test_make_model_fn_matches_jax_fp32_and_bf16(ensemble):
    frames, t, want = _jax_run("perturbed", ensemble, 0.3)
    f0, f1, tt = torch.from_numpy(frames[0]), torch.from_numpy(frames[1]), torch.from_numpy(t)
    sd = _params("perturbed")[0]
    got = pu.make_model_fn(sd, ensemble=ensemble, device="cpu")(f0, f1, tt)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 68, 120, 3)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4
    got16 = pu.make_model_fn(sd, ensemble=ensemble, dtype=torch.bfloat16, device="cpu")(f0, f1, tt)
    assert psnr(got16.numpy(), want) >= 40.0


@pytest.mark.parametrize("ensemble", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_counts_equal_a_forward(ensemble, dtype, monkeypatch):
    """The warps of one forward (all through ``ifrnet.warp_nchw``), routed by
    their planes as the card would route them, against
    ``warps_per_forward``: the frames after each flow block, then per frame
    the refinement's 3 frame warps and its context warp."""
    seen = []
    real = pi.warp

    def spy(img, flow, *args):
        planes = img.permute(0, 3, 1, 2)
        seen.append((warp_kernel.route(planes.shape, planes.stride(), planes.dtype), img.shape[-1]))
        return real(img, flow, *args)

    monkeypatch.setattr(pi, "warp", spy)
    f = [torch.rand(2, 40, 56, 3, generator=torch.Generator().manual_seed(i)) for i in range(2)]
    pu.make_model_fn(pu.init_params(0), ensemble=ensemble, dtype=dtype, device="cpu")(*f, torch.tensor([0.25, 0.75]))
    counts = {"narrow": sum(r == "tiled" for r, _ in seen), "wide": sum(r == "wide" for r, _ in seen)}
    assert counts == pu.warps_per_forward(dtype) == {"narrow": 12, "wide": 2}
    assert [w for _, w in seen] == [3] * 6 + [3, 3, 3, 32] * 2


# ---- d. the golden ----------------------------------------------------------------------------


def make_golden(seed=GOLDEN_SEED):
    """JAX IFUnet fp32 without the ensemble at t = 0.5 on the demo frames
    every eighth pixel, weights ``init_params(seed)``."""
    assert seed == GOLDEN_SEED
    return _demo_frames(), _jax_run("golden", False, 0.5)[2]


def test_golden_fixture_is_current_and_port_matches_it():
    with np.load(GOLDEN) as z:
        seed, t, frames, stored = int(z["seed"]), float(z["t"]), z["frames"], z["output"]
    assert seed == GOLDEN_SEED and t == 0.5 and stored.shape == (1, 68, 120, 3)
    np.testing.assert_array_equal(frames, _demo_frames())
    np.testing.assert_allclose(make_golden(seed)[1], stored, atol=1e-6, rtol=0)
    f0, f1 = (torch.from_numpy(frames[i].astype(np.float32) / 255.0) for i in (0, 1))
    got = pu.make_model_fn(pu.init_params(seed), device="cpu")(f0, f1, torch.tensor([t]))
    assert psnr(got.numpy(), stored) >= 40.0
    assert float(np.abs(got.numpy() - stored).max()) <= 1e-4


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    frames, out = make_golden(GOLDEN_SEED)
    np.savez_compressed(GOLDEN, seed=np.int64(GOLDEN_SEED), t=np.float32(0.5), frames=frames, output=out)
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
