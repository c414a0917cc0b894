"""The port's Sepconv against the JAX package's, on the CPU, with the same
weights (the port's numpy ``init_params`` carried across by
``nest_state_dict``) and the same numpy inputs.

The weights are conditioned as ``bench.py`` conditions them for Sepconv:
each kernel head's last convolution scaled by 0.05 and its bias set to 1/51,
so that a filter's taps sum to about 1, as a trained checkpoint's do. Raw
random weights leave the filtered ones channel that the output is divided
by near 0, and the division turns rounding into a false 17-22 dB.

* ``sepconv_func`` against JAX ``sepconv_func`` at K = 51 and K = 5 (f32,
  within 1e-6 of the largest sum of the products' magnitudes, the scale of
  its rounding), in one band and in many
  (``BAND_ELEMENTS`` made small), and in bf16 (cast back once, within one
  bf16 rounding of the f32 result).
* ``state_dict`` keys and shapes equal the ``sepconv.pth`` manifest (88
  tensors); seeding is deterministic.
* ``make_model_fn`` at an even size (the demo frames every eighth pixel,
  68x120) and an odd one (45x71: the frames padded to 46x72, the decoder's
  upsampling trimmed from 24 to 23 rows and from 10 to 9 columns):
  fp32 within 1e-4 of JAX fp32, bf16 >= 40 dB against JAX fp32.
* The JAX golden (``tests/fixtures/torch_port_sepconv_golden.npz``: the demo
  frames every eighth pixel, conditioned weights from the seed) is
  regenerated with JAX and must be unchanged; the port matches it at
  >= 40 dB and within 1e-4.
* The node against the JAX node (3 frames of 36x60, x2 and x4, fp32):
  >= 40 dB, the original frames passed through bit for bit; the node runs
  from a raw checkpoint exactly as from ``params`` and builds its model
  function once per params.

The JAX model runs through one jitted function with the weights as an
argument (one compile per shape). Run ``python tests/test_torch_sepconv.py``
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

from comfyui_frame_interpolation_tpu.models import sepconv as js
from comfyui_frame_interpolation_tpu.nodes.vfi_nodes import SepconvVFI as JaxSepconv
from comfyui_frame_interpolation_tpu.ops.sepconv import sepconv_func as jax_sepconv
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch.core import config as port_config
from comfyui_frame_interpolation_tpu_torch.models import sepconv as ps
from comfyui_frame_interpolation_tpu_torch.nodes.vfi_nodes import SepconvVFI as PortSepconv
from comfyui_frame_interpolation_tpu_torch.ops import sepconv as psep
from torch_offline import no_downloads  # noqa: F401  (autouse: no download leaves the machine)
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "torch_port_sepconv_golden.npz")
GOLDEN_SEED = 2027
HEADS = ("netVerone", "netVertwo", "netHorone", "netHortwo")


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def conditioned_params(seed):
    """``init_params(seed)`` with each kernel head's last convolution scaled
    by 0.05 and its bias at 1/51 (``bench.py``'s Sepconv conditioning)."""
    sd = ps.init_params(seed)
    for head in HEADS:
        sd[f"{head}.netMain.3.weight"] = sd[f"{head}.netMain.3.weight"] * 0.05
        sd[f"{head}.netMain.3.bias"] = torch.full_like(sd[f"{head}.netMain.3.bias"], 1.0 / 51.0)
    return sd


def _op_inputs(k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((2, 9 + k - 1, 13 + k - 1, 4), dtype=np.float32)
    ver = rng.standard_normal((2, 9, 13, k)).astype(np.float32) / k
    hor = rng.standard_normal((2, 9, 13, k)).astype(np.float32) / k
    return x, ver, hor


@pytest.mark.parametrize("k", [51, 5])
def test_sepconv_func_matches_jax(k, monkeypatch):
    x, ver, hor = _op_inputs(k)
    want = np.asarray(jax_sepconv(jnp.asarray(x), jnp.asarray(ver), jnp.asarray(hor)))
    args = [torch.from_numpy(a) for a in (x, ver, hor)]
    got = psep.sepconv_func(*args)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 9, 13, 4)
    # f32 rounding of a sum of K * K products: relative to the sum of their magnitudes
    tol = 1e-6 * float(np.asarray(jax_sepconv(*(jnp.abs(jnp.asarray(a)) for a in (x, ver, hor)))).max())
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0)
    monkeypatch.setattr(psep, "BAND_ELEMENTS", 1)  # a band per row
    np.testing.assert_allclose(psep.sepconv_func(*args).numpy(), got.numpy(), atol=tol, rtol=0)
    # NHWC views of channels_last NCHW fields, as the model hands them over
    views = [a.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1) for a in args]
    np.testing.assert_allclose(psep.sepconv_func(*views).numpy(), got.numpy(), atol=tol, rtol=0)
    got16 = psep.sepconv_func(*(a.bfloat16() for a in args))
    assert got16.dtype == torch.bfloat16
    ref16 = psep.sepconv_func(*(a.bfloat16().float() for a in args)).bfloat16()
    torch.testing.assert_close(got16, ref16, rtol=0, atol=0)


def test_sepconv_func_checks_its_shapes():
    x, ver, hor = (torch.from_numpy(a) for a in _op_inputs(5))
    with pytest.raises(AssertionError):
        psep.sepconv_func(x[:, 1:], ver, hor)
    with pytest.raises(AssertionError):
        psep.sepconv_func(x, ver, hor[:, :, 1:])


def test_state_dict_equals_the_manifest():
    with open(os.path.join(ROOT, "tests", "fixtures", "ckpt_manifests.json")) as f:
        want = json.load(f)["manifests"]["sepconv.pth"]["tensors"]
    sd = ps.init_params(0)
    assert {k: list(v.shape) for k, v in sd.items()} == want and len(sd) == 88
    assert torch.equal(sd["netDecode.0.netHor.0.netMain.0.weight"], torch.full((1,), 0.25))


def test_init_params_is_seeded():
    a, b, c = ps.init_params(0), ps.init_params(0), ps.init_params(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["netHortwo.netMain.3.weight"], c["netHortwo.netMain.3.weight"])


def _demo_frames():
    """``anime0.png`` and ``anime1.png`` every eighth pixel, uint8 ``[2, 1,
    68, 120, 3]``."""
    from PIL import Image

    imgs = [np.asarray(Image.open(os.path.join(ROOT, "demo_frames", f"anime{i}.png")).convert("RGB")) for i in (0, 1)]
    return np.stack(imgs)[:, None, ::8, ::8]


_jax_apply = jax.jit(js.apply)


@functools.lru_cache(maxsize=None)
def _jax_run(seed, odd):
    """The demo frames (``odd``: their 45x71 corner) as floats, the
    conditioned weights of ``seed`` and JAX's output."""
    frames = _demo_frames().astype(np.float32) / 255.0
    if odd:
        frames = frames[:, :, :45, :71]
    sd = conditioned_params(seed)
    out = _jax_apply(to_jax_tree(nest_state_dict(sd)), jnp.asarray(frames[0]), jnp.asarray(frames[1]))
    return frames, sd, np.asarray(out)


@pytest.mark.parametrize("odd", [False, True], ids=["68x120", "45x71"])
def test_make_model_fn_matches_jax_fp32_and_bf16(odd):
    frames, sd, want = _jax_run(0, odd)
    f0, f1 = torch.from_numpy(frames[0]), torch.from_numpy(frames[1])
    got = ps.make_model_fn(sd, device="cpu")(f0, f1, torch.tensor([0.5]))
    assert got.dtype == torch.float32 and tuple(got.shape) == frames[0].shape
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4
    got16 = ps.make_model_fn(sd, dtype=torch.bfloat16, device="cpu")(f0, f1, torch.tensor([0.5]))
    assert got16.dtype == torch.float32
    assert psnr(got16.numpy(), want) >= 40.0


def make_golden(seed=GOLDEN_SEED):
    """JAX Sepconv fp32 on the demo frames every eighth pixel, conditioned
    weights of ``seed``."""
    assert seed == GOLDEN_SEED
    return _demo_frames(), _jax_run(seed, False)[2]


def test_golden_fixture_is_current_and_port_matches_it():
    with np.load(GOLDEN) as z:
        seed, frames, stored = int(z["seed"]), z["frames"], z["output"]
    assert seed == GOLDEN_SEED and stored.shape == (1, 68, 120, 3)
    np.testing.assert_array_equal(frames, _demo_frames())
    np.testing.assert_allclose(make_golden(seed)[1], stored, atol=1e-6, rtol=0)
    f0, f1 = (torch.from_numpy(frames[i].astype(np.float32) / 255.0) for i in (0, 1))
    got = ps.make_model_fn(conditioned_params(seed), device="cpu")(f0, f1, None)
    assert psnr(got.numpy(), stored) >= 40.0
    assert float(np.abs(got.numpy() - stored).max()) <= 1e-4


def _three_frames():
    pair = _demo_frames()[:, 0, :36, :60].astype(np.float32) / 255.0
    return np.concatenate([pair, pair[:1]])  # two pairs: 0->1, 1->0


@functools.lru_cache(maxsize=None)
def _jax_params():
    """One JAX tree for both multipliers, so the JAX node compiles once."""
    return to_jax_tree(nest_state_dict(conditioned_params(0)))


@pytest.mark.parametrize("multiplier", [2, 4])
def test_node_matches_jax_node(multiplier):
    frames = _three_frames()
    before = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)  # the node jits its weights in as constants
    try:
        ref = np.asarray(JaxSepconv().vfi("sepconv.pth", frames, multiplier=multiplier, params=_jax_params())[0])
    finally:
        jax.config.update("jax_persistent_cache_min_compile_time_secs", before)
    (got,) = PortSepconv().vfi("sepconv.pth", frames, multiplier=multiplier, params=conditioned_params(0), device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (2 * multiplier + 1, 36, 60, 3)
    np.testing.assert_array_equal(got.numpy()[::multiplier], frames)
    assert psnr(got.numpy(), ref) >= 40.0


def test_node_runs_from_its_checkpoint_and_caches_its_model_fn(tmp_path, monkeypatch):
    sd = conditioned_params(1)
    frames = np.random.default_rng(2).random((2, 16, 24, 3), dtype=np.float32)
    (tmp_path / "sepconv").mkdir()
    torch.save(sd, str(tmp_path / "sepconv" / "sepconv.pth"))
    monkeypatch.setitem(port_config.load_config(), "ckpts_path", str(tmp_path))
    (from_file,) = PortSepconv().vfi("sepconv.pth", frames, device="cpu")
    node = PortSepconv()
    (from_params,) = node.vfi("sepconv.pth", frames, params=sd, device="cpu")
    node.vfi("sepconv.pth", frames, params=sd, device="cpu")
    assert len(node._model_fns) == 1 and tuple(from_file.shape) == (3, 16, 24, 3)
    torch.testing.assert_close(from_file, from_params, rtol=0, atol=0)
    with pytest.raises(ValueError, match="at least 2 frames"):
        node.vfi("sepconv.pth", frames[:1], params=sd, device="cpu")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    frames, out = make_golden(GOLDEN_SEED)
    np.savez_compressed(GOLDEN, seed=np.int64(GOLDEN_SEED), frames=frames, output=out)
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
