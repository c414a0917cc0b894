"""The port's RIFE against the JAX package's, on the CPU, with the same weights
carried across by ``params_from_jax``.

* ``apply`` for 4.6 and 4.7 (ensemble off and on), 4.17 and 4.26 at full width on
  ``[2, 64, 128, 3]`` frames with ``t = [0.5, 0.25]``: fp32 max-abs <= 1e-4
  (convolution sums are taken in another order than XLA:CPU's).
* ``make_model_fn`` in bf16 against JAX fp32: PSNR >= 40 dB.
* the JAX golden fixture (``tests/fixtures/torch_port_rife47_golden.npz``)
  is regenerated with JAX and must be unchanged; the port matches it.

Run ``python tests/test_torch_rife.py`` to rewrite the fixture.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.models import rife as jrife
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch.models import rife as prife
from comfyui_frame_interpolation_tpu_torch.utils.ckpt import params_from_jax

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port_rife47_golden.npz")
GOLDEN_SEED = 1234


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def _frames(seed=0, shape=(2, 64, 128, 3)):
    rng = np.random.default_rng(seed)
    return rng.random(shape, dtype=np.float32), rng.random(shape, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """A JAX parameter tree of numpy leaves, drawn by the port's
    ``init_params`` (JAX's own takes ~10 s to compile on a CPU; one test below
    carries it across instead)."""
    return nest_state_dict(prife.init_params(0, arch))


def _jax_apply(params, f0, f1, t, arch, ensemble=False):
    fn = jax.jit(
        functools.partial(
            jrife.apply, scale_list=jrife.default_scale_list(arch), arch_ver=arch, ensemble=ensemble
        )
    )
    return np.asarray(fn(params, jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(t)))


def _port_apply(sd, f0, f1, t, arch, ensemble=False):
    with torch.device("meta"):
        net = prife.IFNet(arch)
    net.load_state_dict(sd, strict=True, assign=True)
    net = net.to(memory_format=torch.channels_last)
    with torch.inference_mode():
        out = prife.apply(
            net, torch.from_numpy(f0), torch.from_numpy(f1), torch.as_tensor(t),
            prife.default_scale_list(arch), ensemble=ensemble,
        )
    return out.numpy()


@pytest.mark.parametrize(
    "arch,ensemble", [("4.6", False), ("4.6", True), ("4.7", False), ("4.7", True), ("4.17", False), ("4.26", False)]
)
def test_apply_matches_jax_fp32(arch, ensemble):
    f0, f1 = _frames(0)
    t = np.asarray([0.5, 0.25], np.float32)
    jp = _jax_params(arch)
    ref = _jax_apply(jp, f0, f1, t, arch, ensemble)
    got = _port_apply(params_from_jax(jp), f0, f1, t, arch, ensemble)
    assert got.shape == ref.shape == (2, 64, 128, 3)
    assert np.abs(got - ref).max() <= 1e-4


def test_make_model_fn_bf16_vs_jax_fp32():
    f0, f1 = _frames(1)
    t = np.asarray([0.5, 0.25], np.float32)
    # the JAX package's own random init, carried across by params_from_jax
    init = jax.jit(jrife.init_params, static_argnums=1)
    jp = jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(0), "4.7"))
    ref = np.clip(_jax_apply(jp, f0, f1, t, "4.7"), 0.0, 1.0)
    fn = prife.make_model_fn(params_from_jax(jp), "4.7", dtype=torch.bfloat16, device="cpu")
    got = fn(torch.from_numpy(f0), torch.from_numpy(f1), torch.from_numpy(t))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 64, 128, 3)
    assert psnr(got.numpy(), ref) >= 40.0


def test_state_dict_equals_rife47_checkpoint_manifest():
    path = os.path.join(os.path.dirname(__file__), "fixtures", "ckpt_manifests.json")
    with open(path) as f:
        manifest = json.load(f)["manifests"]["rife47.pth"]["tensors"]
    with torch.device("meta"):
        sd = prife.IFNet("4.7").state_dict()
    assert {k: list(v.shape) for k, v in sd.items()} == manifest


@pytest.mark.parametrize("arch", ["4.7", "4.17", "4.26"])
def test_init_params_shapes_match_jax_and_are_seeded(arch):
    sd = prife.init_params(0, arch)
    ref = jax.eval_shape(functools.partial(jrife.init_params, arch_ver=arch), jax.random.PRNGKey(0))
    ref = params_from_jax(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), ref))
    assert {k: (tuple(v.shape), v.dtype) for k, v in sd.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in ref.items()
    }
    again = prife.init_params(0, arch)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["block0.conv0.0.0.weight"], prife.init_params(1, arch)["block0.conv0.0.0.weight"])


def test_rife46_layout_has_no_encoder():
    """4.6 (GMFSS union's ``ifnet``): four blocks taking 7 then 12 channels,
    widths 192/128/96/64, a 24-channel transposed-conv head, no encoder."""
    with torch.device("meta"):
        sd = prife.IFNet("4.6").state_dict()
    assert {k.split(".")[0] for k in sd} == {"block0", "block1", "block2", "block3"}
    for i, (cin, c) in enumerate(((7, 192), (12, 128), (12, 96), (12, 64))):
        assert tuple(sd[f"block{i}.conv0.0.0.weight"].shape) == (c // 2, cin, 3, 3)
        assert tuple(sd[f"block{i}.lastconv.0.weight"].shape) == (c, 24, 4, 4)
    assert len(prife.init_params(0, "4.6")) == len(sd) == 4 * (4 + 8 * 3 + 2)


@pytest.mark.parametrize("arch", ["4.0", "4.5", "4.10"])
def test_unported_arch_raises(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        prife.IFNet(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        prife.make_model_fn({}, arch, device="cpu")


def test_make_model_fn_loads_strictly():
    sd = prife.init_params(0, "4.7")
    del sd["encode.1.bias"]
    with pytest.raises(RuntimeError, match="encode.1.bias"):
        prife.make_model_fn(sd, "4.7", device="cpu")


def golden_inputs(seed):
    """Frames ``[2, 1, 64, 128, 3]`` and the 4.7 weights of the golden case."""
    frames = np.random.default_rng(seed).random((2, 1, 64, 128, 3), dtype=np.float32)
    return frames, prife.init_params(seed, "4.7")


def make_golden(seed=GOLDEN_SEED):
    """JAX RIFE 4.7 fp32 output at t=0.5 on the golden inputs."""
    frames, sd = golden_inputs(seed)
    params = to_jax_tree(nest_state_dict(sd))
    return _jax_apply(params, frames[0], frames[1], np.asarray([0.5], np.float32), "4.7")


def test_golden_fixture_is_current_and_port_matches_it():
    with np.load(GOLDEN) as z:
        seed, stored = int(z["seed"]), z["output"]
    assert seed == GOLDEN_SEED and stored.shape == (1, 64, 128, 3)
    np.testing.assert_allclose(make_golden(seed), stored, atol=1e-6, rtol=0)
    frames, sd = golden_inputs(seed)
    got = _port_apply(sd, frames[0], frames[1], np.asarray([0.5], np.float32), "4.7")
    assert np.abs(got - stored).max() <= 1e-4


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(GOLDEN, seed=np.int64(GOLDEN_SEED), output=make_golden(GOLDEN_SEED))
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
