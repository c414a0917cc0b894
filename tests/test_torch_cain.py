"""The port's CAIN against the JAX package's, on the CPU, with the same weights
(the port's numpy ``init_params`` carried across by ``nest_state_dict``) and
the same numpy inputs.

* ``common.reflect_pad`` equals ``numpy.pad(mode="reflect")`` exactly on
  sides of 2-60 pixels with pads up to three times the side (the repeated
  reflection that ``F.pad`` refuses).
* ``F.pixel_unshuffle``/``F.pixel_shuffle`` by 8 equal the JAX
  ``_space_to_depth``/``_depth_to_space`` exactly.
* ``state_dict`` keys and shapes equal the ``pretrained_cain.pth`` manifest
  (494 tensors); seeding is deterministic.
* ``make_model_fn`` on the demo frames every eighth pixel (68x120, padded to
  128x128 inside) and on a 36x60 crop of them (its pads of 46 and 34 are
  longer than the sides less one): fp32 within 1e-4 of JAX fp32, bf16
  >= 40 dB against JAX fp32.
* The JAX golden (``tests/fixtures/torch_port_cain_golden.npz``: the demo
  frames every eighth pixel, weights from the seed) is regenerated with JAX
  and must be unchanged; the port matches it at >= 40 dB and within 1e-4.
* The node against the JAX node (3 frames of 36x60, x2 and x4, fp32):
  >= 40 dB, the original frames passed through bit for bit; the node runs
  from a checkpoint in the reference's container (``state_dict`` with
  ``module.``) exactly as from ``params``, and builds its model function once
  per params.

The JAX model runs through one jitted function with the weights as an
argument (one compile per shape). Run ``python tests/test_torch_cain.py`` to
rewrite the fixture.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.models import cain as jc
from comfyui_frame_interpolation_tpu.nodes.vfi_nodes import CAIN_VFI as JaxCAIN
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch.core import config as port_config
from comfyui_frame_interpolation_tpu_torch.models import cain as pc
from comfyui_frame_interpolation_tpu_torch.models.common import reflect_pad
from comfyui_frame_interpolation_tpu_torch.nodes.vfi_nodes import CAIN_VFI as PortCAIN
from torch_offline import no_downloads  # noqa: F401  (autouse: no download leaves the machine)
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "torch_port_cain_golden.npz")
GOLDEN_SEED = 2026


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


@settings(max_examples=60, deadline=None)
@given(
    h=st.integers(2, 60), w=st.integers(2, 60), data=st.data(),
)
def test_reflect_pad_equals_numpy(h, w, data):
    left, right = (data.draw(st.integers(0, 3 * w)) for _ in range(2))
    top, bottom = (data.draw(st.integers(0, 3 * h)) for _ in range(2))
    x = np.random.default_rng(h * 61 + w).random((1, 2, h, w), dtype=np.float32)
    want = np.pad(x, ((0, 0), (0, 0), (top, bottom), (left, right)), mode="reflect")
    got = reflect_pad(torch.from_numpy(x), (left, right, top, bottom)).numpy()
    np.testing.assert_array_equal(got, want)


def test_space_to_depth_is_pixel_unshuffle():
    x = np.random.default_rng(0).random((2, 16, 24, 3), dtype=np.float32)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    s2d = F.pixel_unshuffle(nchw, 8)
    np.testing.assert_array_equal(s2d.permute(0, 2, 3, 1).numpy(), np.asarray(jc._space_to_depth(jnp.asarray(x), 8)))
    y = np.random.default_rng(1).random((2, 2, 3, 192), dtype=np.float32)
    d2s = F.pixel_shuffle(torch.from_numpy(y).permute(0, 3, 1, 2), 8).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(d2s.numpy(), np.asarray(jc._depth_to_space(jnp.asarray(y), 8)))


def test_state_dict_equals_the_manifest():
    with open(os.path.join(ROOT, "tests", "fixtures", "ckpt_manifests.json")) as f:
        want = json.load(f)["manifests"]["pretrained_cain.pth"]["tensors"]
    sd = pc.init_params(0)
    assert {k: list(v.shape) for k, v in sd.items()} == want and len(sd) == 494


def test_init_params_is_seeded():
    a, b, c = pc.init_params(0), pc.init_params(0), pc.init_params(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    key = "encoder.interpolate.body.4.body.11.body.2.conv.weight"
    assert not torch.equal(a[key], c[key])


def _demo_frames():
    """``anime0.png`` and ``anime1.png`` every eighth pixel, uint8 ``[2, 1,
    68, 120, 3]``."""
    from PIL import Image

    imgs = [np.asarray(Image.open(os.path.join(ROOT, "demo_frames", f"anime{i}.png")).convert("RGB")) for i in (0, 1)]
    return np.stack(imgs)[:, None, ::8, ::8]


_jax_apply = jax.jit(jc.apply)


@functools.lru_cache(maxsize=None)
def _jax_run(seed, crop):
    """The demo frames (``crop``: the 36x60 corner) as floats, the port's
    weights ``init_params(seed)`` and JAX's output."""
    frames = _demo_frames().astype(np.float32) / 255.0
    if crop:
        frames = frames[:, :, :36, :60]
    sd = pc.init_params(seed)
    out = _jax_apply(to_jax_tree(nest_state_dict(sd)), jnp.asarray(frames[0]), jnp.asarray(frames[1]))
    return frames, sd, np.asarray(out)


@pytest.mark.parametrize("crop", [False, True], ids=["68x120", "36x60"])
def test_make_model_fn_matches_jax_fp32_and_bf16(crop):
    frames, sd, want = _jax_run(0, crop)
    f0, f1 = torch.from_numpy(frames[0]), torch.from_numpy(frames[1])
    got = pc.make_model_fn(sd, device="cpu")(f0, f1, torch.tensor([0.5]))
    assert got.dtype == torch.float32 and tuple(got.shape) == frames[0].shape
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4
    got16 = pc.make_model_fn(sd, dtype=torch.bfloat16, device="cpu")(f0, f1, torch.tensor([0.5]))
    assert got16.dtype == torch.float32
    assert psnr(got16.numpy(), want) >= 40.0


def make_golden(seed=GOLDEN_SEED):
    """JAX CAIN fp32 on the demo frames every eighth pixel, weights
    ``init_params(seed)``."""
    assert seed == GOLDEN_SEED
    return _demo_frames(), _jax_run(seed, False)[2]


def test_golden_fixture_is_current_and_port_matches_it():
    with np.load(GOLDEN) as z:
        seed, frames, stored = int(z["seed"]), z["frames"], z["output"]
    assert seed == GOLDEN_SEED and stored.shape == (1, 68, 120, 3)
    np.testing.assert_array_equal(frames, _demo_frames())
    np.testing.assert_allclose(make_golden(seed)[1], stored, atol=1e-6, rtol=0)
    f0, f1 = (torch.from_numpy(frames[i].astype(np.float32) / 255.0) for i in (0, 1))
    got = pc.make_model_fn(pc.init_params(seed), device="cpu")(f0, f1, None)
    assert psnr(got.numpy(), stored) >= 40.0
    assert float(np.abs(got.numpy() - stored).max()) <= 1e-4


def _three_frames():
    pair = _demo_frames()[:, 0, :36, :60].astype(np.float32) / 255.0
    return np.concatenate([pair, pair[:1]])  # two pairs: 0->1, 1->0


@functools.lru_cache(maxsize=None)
def _jax_params():
    """One JAX tree for both multipliers, so the JAX node compiles once."""
    return to_jax_tree(nest_state_dict(pc.init_params(0)))


@pytest.mark.parametrize("multiplier", [2, 4])
def test_node_matches_jax_node(multiplier):
    frames = _three_frames()
    before = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)  # the node jits its 42 M weights in as constants
    try:
        ref = np.asarray(JaxCAIN().vfi("pretrained_cain.pth", frames, multiplier=multiplier, params=_jax_params())[0])
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", before)
    (got,) = PortCAIN().vfi("pretrained_cain.pth", frames, multiplier=multiplier, params=pc.init_params(0), device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (2 * multiplier + 1, 36, 60, 3)
    np.testing.assert_array_equal(got.numpy()[::multiplier], frames)
    assert psnr(got.numpy(), ref) >= 40.0


def test_node_runs_from_its_checkpoint_and_caches_its_model_fn(tmp_path, monkeypatch):
    sd = pc.init_params(1)
    frames = np.random.default_rng(2).random((2, 16, 24, 3), dtype=np.float32)
    (tmp_path / "cain").mkdir()
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, str(tmp_path / "cain" / "pretrained_cain.pth"))
    monkeypatch.setitem(port_config.load_config(), "ckpts_path", str(tmp_path))
    (from_file,) = PortCAIN().vfi("pretrained_cain.pth", frames, device="cpu")
    node = PortCAIN()
    (from_params,) = node.vfi("pretrained_cain.pth", frames, params=sd, device="cpu")
    node.vfi("pretrained_cain.pth", frames, params=sd, device="cpu")
    assert len(node._model_fns) == 1 and tuple(from_file.shape) == (3, 16, 24, 3)
    torch.testing.assert_close(from_file, from_params, rtol=0, atol=0)
    with pytest.raises(ValueError, match="at least 2 frames"):
        node.vfi("pretrained_cain.pth", frames[:1], params=sd, device="cpu")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    frames, out = make_golden(GOLDEN_SEED)
    np.savez_compressed(GOLDEN, seed=np.int64(GOLDEN_SEED), frames=frames, output=out)
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
