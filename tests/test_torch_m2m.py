"""The port's M2M against the JAX package's, on the CPU, with the same weights
(the port's numpy ``init_params`` carried across by ``nest_state_dict``).

* ``state_dict`` keys and shapes equal the released ``M2M.pth`` manifest
  (``tests/fixtures/ckpt_manifests.json``, 188 tensors).
* ``pair_reuse``, entry by entry, fp32: max abs error <= 2e-5 x (1 + the
  entry's largest magnitude). The convolutions sum in another order than
  XLA:CPU's, and the photometric metrics (up to ``paramAlpha`` = 10) read
  warps at flows that differ by ~1e-6 px.
* ``apply`` at ``[2, 64, 128, 3]``, t = 0.5 and t = [0.25, 0.75]: >= 40 dB
  fp32. The hole mask is a threshold (normaliser < 1e-5), so a pixel at the
  edge can flip between the two; the test counts the flipped pixels and
  prints the count.
* ``make_model_fn`` in bf16 against JAX fp32: >= 35 dB.
* the branch images are ``repeat_interleave``'s values in ``channels_last``
  memory.
* the JAX golden fixture (``tests/fixtures/torch_port_m2m_golden.npz``) is
  regenerated with JAX and must be unchanged; the port matches it.

JAX's ``apply`` is ``pair_infer`` of ``pair_reuse`` (``m2m.py:324-328``); the
two halves are jitted here once each, so one XLA compile of the heavy half
serves every case (XLA:CPU takes ~12 s for it).

Run ``python tests/test_torch_m2m.py`` to rewrite the fixture.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.models import m2m as jm
from comfyui_frame_interpolation_tpu.ops.softsplat import _softsplat_xla
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch.models import m2m as pm
from comfyui_frame_interpolation_tpu_torch.utils.ckpt import params_from_jax

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port_m2m_golden.npz")
GOLDEN_SEED = 1234
GOLDEN_T = (0.5, 0.25)
SHAPE = (2, 64, 128, 3)

_jax_reuse = jax.jit(jm.pair_reuse)
_jax_infer = jax.jit(jm.pair_infer, static_argnums=(3,))


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def _frames(seed):
    rng = np.random.default_rng(seed)
    return rng.random(SHAPE, dtype=np.float32), rng.random(SHAPE, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _case(seed):
    """(frames, port state dict, JAX tree, JAX reuse cache as numpy)."""
    f0, f1 = _frames(seed)
    sd = pm.init_params(seed)
    jp = to_jax_tree(nest_state_dict(sd))
    cache = _jax_reuse(jp, jnp.asarray(f0), jnp.asarray(f1))
    return (f0, f1), sd, jp, cache


def _jax_apply(seed, t):
    (f0, _), _, jp, cache = _case(seed)
    return np.asarray(_jax_infer(jp, cache, jnp.asarray(t, jnp.float32), f0.shape[1:3]))


def _port_net(sd, dtype=torch.float32):
    return pm._load(sd, dtype, "cpu")


def _hole_mask(cache, t):
    """The merge's hole mask (``m2m.py:299-313``) of a cache of numpy arrays,
    with the JAX splat: normaliser + 2*BRANCH*1e-7 < 1e-5."""
    n = cache["im0_o"].shape[0]
    t_b = np.repeat(np.broadcast_to(np.asarray(t, np.float32).reshape(-1), (n,)), pm.BRANCH).reshape(-1, 1, 1, 1)
    weight = np.concatenate([
        (1.0 - t_b) * np.exp(np.clip(cache["metric0"], -20, 20)),
        t_b * np.exp(np.clip(cache["metric1"], -20, 20)),
    ])
    flow = np.concatenate([cache["fwd_b"] * t_b, cache["bwd_b"] * (1.0 - t_b)])
    out = np.asarray(_softsplat_xla(jnp.asarray(weight), jnp.asarray(flow)))
    norm = out.reshape(2, n, pm.BRANCH, *out.shape[1:]).sum((0, 2)) + 2 * pm.BRANCH * 1e-7
    return norm[..., 0] < 1e-5


def test_state_dict_equals_m2m_checkpoint_manifest():
    path = os.path.join(os.path.dirname(__file__), "fixtures", "ckpt_manifests.json")
    with open(path) as f:
        manifest = json.load(f)["manifests"]["M2M.pth"]["tensors"]
    with torch.device("meta"):
        sd = pm.M2M_PWC().state_dict()
    assert len(sd) == 188
    assert {k: list(v.shape) for k, v in sd.items()} == manifest
    assert sum(int(np.prod(s)) for s in manifest.values()) == 7_610_715


def test_init_params_is_seeded_with_stated_constants():
    sd = pm.init_params(0)
    again = pm.init_params(0)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    key = "netFlow.netFiv.netMain.netMain.0.weight"
    assert not torch.equal(sd[key], pm.init_params(1)[key])
    assert torch.equal(sd["paramAlpha"], torch.full((1, 1, 1, 1), pm.PARAM_ALPHA_INIT))
    assert torch.equal(sd["netFlow.netOne.netCostacti.weight"], torch.full((1,), pm.PRELU_INIT))
    assert torch.equal(sd["MRN.motion_encdec.up3.1.weight"], torch.full((16,), pm.PRELU_INIT))
    bound = 1.0 / np.sqrt(113 * 9)
    assert float(sd[key].abs().max()) <= bound


def test_params_from_jax_round_trips_the_weights():
    sd = pm.init_params(0)
    back = params_from_jax(nest_state_dict(sd))
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    pm.make_model_fn(back, device="cpu")  # loads with strict=True


def test_pair_reuse_matches_jax_entry_by_entry():
    (f0, f1), sd, _, cache = _case(0)
    with torch.inference_mode():
        got = pm.pair_reuse(_port_net(sd), torch.from_numpy(f0), torch.from_numpy(f1))
    assert got.keys() == cache.keys()
    for k, ref in cache.items():
        ref = np.asarray(ref)
        assert tuple(got[k].shape) == ref.shape, k
        err = float(np.abs(got[k].numpy() - ref).max())
        assert err <= 2e-5 * (1.0 + float(np.abs(ref).max())), (k, err)


@pytest.mark.parametrize("t", [0.5, (0.25, 0.75)])
def test_apply_matches_jax_fp32(t):
    (f0, f1), sd, _, cache = _case(0)
    ref = _jax_apply(0, t)
    net = _port_net(sd)
    with torch.inference_mode():
        got = pm.apply(net, torch.from_numpy(f0), torch.from_numpy(f1), torch.tensor(t))
        port_cache = pm.pair_reuse(net, torch.from_numpy(f0), torch.from_numpy(f1))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == SHAPE
    holes_ref = _hole_mask({k: np.asarray(v) for k, v in cache.items()}, t)
    holes_got = _hole_mask({k: v.numpy() for k, v in port_cache.items()}, t)
    flipped = int((holes_ref != holes_got).sum())
    p = psnr(got.numpy(), ref)
    print(f"M2M apply t={t}: {p:.2f} dB, {int(holes_ref.sum())} hole pixels, {flipped} flipped")
    assert flipped <= holes_ref.size // 1000
    assert p >= 40.0


def test_make_model_fn_bf16_vs_jax_fp32():
    (f0, f1), sd, _, _ = _case(0)
    t = (0.25, 0.75)
    ref = _jax_apply(0, t)
    fn = pm.make_model_fn(sd, dtype=torch.bfloat16, device="cpu")
    got = fn(torch.from_numpy(f0), torch.from_numpy(f1), torch.tensor(t))
    assert got.dtype == torch.float32 and tuple(got.shape) == SHAPE
    p = psnr(got.numpy(), ref)
    print(f"M2M make_model_fn bf16 vs JAX fp32: {p:.2f} dB")
    assert p >= 35.0


def test_pair_infer_fills_holes_as_jax():
    """Random weights leave no holes at this size, so the merge's hole path
    runs on a cache whose flows both push the frame 40 px right: the left
    strip, 40*min(t, 1-t) px wide, holds no splat and takes the time-blended
    fill."""
    (f0, _), sd, jp, cache = _case(0)
    cache = {k: np.asarray(v).copy() for k, v in cache.items()}
    cache["fwd_b"][..., 0] += 40.0
    cache["bwd_b"][..., 0] += 40.0
    t = (0.25, 0.75)
    ref = np.asarray(_jax_infer(jp, {k: jnp.asarray(v) for k, v in cache.items()}, jnp.asarray(t, jnp.float32), f0.shape[1:3]))
    with torch.inference_mode():
        got = pm.pair_infer(_port_net(sd), {k: torch.from_numpy(v) for k, v in cache.items()}, torch.tensor(t), f0.shape[1:3])
    holes = _hole_mask(cache, t)
    assert holes.sum() > 0.05 * holes.size
    p = psnr(got.numpy(), ref)
    print(f"M2M pair_infer with {int(holes.sum())} hole pixels: {p:.2f} dB")
    assert p >= 40.0


def test_branch_images_are_repeated_into_channels_last():
    """The metrics' and the splat's branch images: ``repeat_interleave``'s
    values, in ``channels_last`` memory (so their warps take K1's tiled body
    on the card)."""
    x = torch.from_numpy(np.random.default_rng(7).random((2, 3, 8, 12), dtype=np.float32))
    x = x.contiguous(memory_format=torch.channels_last)
    got = pm._repeat_branches(x)
    assert torch.equal(got, x.repeat_interleave(pm.BRANCH, 0))
    assert got.stride(1) == 1 and got.is_contiguous(memory_format=torch.channels_last)


def test_make_model_fn_loads_strictly():
    sd = pm.init_params(0)
    del sd["paramAlpha"]
    with pytest.raises(RuntimeError, match="paramAlpha"):
        pm.make_model_fn(sd, device="cpu")


def make_golden(seed=GOLDEN_SEED):
    """JAX M2M fp32 output at t = GOLDEN_T on the frames and weights of
    ``seed``."""
    return _jax_apply(seed, GOLDEN_T)


def test_golden_fixture_is_current_and_port_matches_it():
    with np.load(GOLDEN) as z:
        seed, t, stored = int(z["seed"]), tuple(z["t"].tolist()), z["output"]
    assert seed == GOLDEN_SEED and t == GOLDEN_T and stored.shape == SHAPE
    np.testing.assert_allclose(make_golden(seed), stored, atol=1e-6, rtol=0)
    (f0, f1), sd, _, _ = _case(seed)
    with torch.inference_mode():
        got = pm.apply(_port_net(sd), torch.from_numpy(f0), torch.from_numpy(f1), torch.tensor(t))
    assert psnr(got.numpy(), stored) >= 40.0


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(
        GOLDEN, seed=np.int64(GOLDEN_SEED), t=np.asarray(GOLDEN_T, np.float32), output=make_golden(GOLDEN_SEED)
    )
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
