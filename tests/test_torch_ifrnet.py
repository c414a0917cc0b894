"""The port's IFRNet against the JAX package's, on the CPU, with the same weights
(the port's numpy ``init_params`` carried across by ``nest_state_dict``) and
the same numpy inputs.

* ``state_dict`` keys and shapes equal the ``IFRNet_S_Vimeo90K.pth``
  manifest (104 tensors); L has the same keys at its widths; seeding is
  deterministic.
* ``make_model_fn`` end to end on the demo frames every eighth pixel (68x120,
  padded to 128x128 inside) for S and L at ``scale_factor`` 1 and S at 0.5:
  fp32 within 1e-4 of JAX fp32, bf16 >= 40 dB against JAX fp32.
* ``warps_per_forward`` equals the warps a forward makes, routed as the card
  would route them (2 K1, 6 wide: C = 54, 36, 24 for S, 144, 96, 64 for L).
* The JAX golden (``tests/fixtures/torch_port_ifrnet_golden.npz``: the demo
  frames every eighth pixel, S, t = 0.5, weights from the seed) is
  regenerated with JAX and must be unchanged; the port matches it at >= 40 dB.

Every JAX run goes through one jitted function with the weights as an
argument, compiled once per variant and scale at the golden's shape. Run
``python tests/test_torch_ifrnet.py`` to rewrite the fixture.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.models import ifrnet as ji
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch.models import ifrnet as pi
from comfyui_frame_interpolation_tpu_torch.ops.cuda import warp_kernel
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "torch_port_ifrnet_golden.npz")
GOLDEN_SEED = 2024


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def _demo_frames():
    """``anime0.png`` and ``anime1.png`` every eighth pixel, uint8 ``[2, 1,
    68, 120, 3]``."""
    from PIL import Image

    imgs = [np.asarray(Image.open(os.path.join(ROOT, "demo_frames", f"anime{i}.png")).convert("RGB")) for i in (0, 1)]
    return np.stack(imgs)[:, None, ::8, ::8]


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jax_fn(p, f0, f1, t, variant, scale):
    return ji.apply(p, f0, f1, t, scale_factor=scale, variant=variant)


@functools.lru_cache(maxsize=None)
def _jax_run(variant, scale, seed, t):
    """The demo frames as floats, the port's weights ``init_params(variant,
    seed)``, ``t`` as an array and JAX's output."""
    frames = _demo_frames().astype(np.float32) / 255.0
    sd = pi.init_params(variant, seed)
    t = np.asarray([t], np.float32)
    out = _jax_fn(to_jax_tree(nest_state_dict(sd)), jnp.asarray(frames[0]), jnp.asarray(frames[1]), jnp.asarray(t), variant, scale)
    return frames, sd, t, np.asarray(out)


def test_state_dict_equals_the_manifest():
    with open(os.path.join(ROOT, "tests", "fixtures", "ckpt_manifests.json")) as f:
        want = json.load(f)["manifests"]["IFRNet_S_Vimeo90K.pth"]["tensors"]
    s = pi.init_params("S", 0)
    assert {k: list(v.shape) for k, v in s.items()} == want and len(s) == 104
    big = pi.init_params("L", 0)
    assert big.keys() == s.keys()
    assert tuple(big["encoder.pyramid1.0.0.weight"].shape) == (64, 3, 7, 7)
    assert tuple(big["decoder4.convblock.0.0.weight"].shape) == (384, 385, 3, 3)
    assert tuple(big["decoder1.convblock.1.conv2.0.weight"].shape) == (64, 64, 3, 3)


def test_init_params_is_seeded():
    a, b, c = pi.init_params("S", 0), pi.init_params("S", 0), pi.init_params("S", 1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decoder1.convblock.2.weight"], c["decoder1.convblock.2.weight"])
    assert torch.equal(a["encoder.pyramid1.0.1.weight"], torch.full((24,), 0.25))
    assert pi.variant_for_ckpt("IFRNet_S_GoPro.pth") == "S" and pi.variant_for_ckpt("IFRNet_L_Vimeo90K.pth") == "L"


@pytest.mark.parametrize("variant,scale", [("S", 1.0), ("L", 1.0), ("S", 0.5)])
def test_make_model_fn_matches_jax_fp32_and_bf16(variant, scale):
    frames, sd, t, want = _jax_run(variant, scale, 0, 0.3)
    f0, f1, tt = torch.from_numpy(frames[0]), torch.from_numpy(frames[1]), torch.from_numpy(t)
    got = pi.make_model_fn(sd, variant, scale, device="cpu")(f0, f1, tt)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 68, 120, 3)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4
    got16 = pi.make_model_fn(sd, variant, scale, dtype=torch.bfloat16, device="cpu")(f0, f1, tt)
    assert got16.dtype == torch.float32
    assert psnr(got16.numpy(), want) >= 40.0


@pytest.mark.parametrize("variant", ["S", "L"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_launch_counts_equal_a_forward(variant, dtype, monkeypatch):
    """The warps of one forward on the CPU, routed by their planes as the
    card would route them, against ``warps_per_forward``; the widths in the
    order the model makes them."""
    seen = []
    real = pi.warp

    def spy(img, flow, *args):
        planes = img.permute(0, 3, 1, 2)
        seen.append((warp_kernel.route(planes.shape, planes.stride(), planes.dtype), img.shape[-1]))
        return real(img, flow, *args)

    monkeypatch.setattr(pi, "warp", spy)
    f = [torch.rand(2, 40, 56, 3, generator=torch.Generator().manual_seed(i)) for i in range(2)]
    pi.make_model_fn(pi.init_params(variant, 0), variant, dtype=dtype, device="cpu")(*f, torch.tensor([0.25, 0.75]))
    counts = {"narrow": sum(r == "tiled" for r, _ in seen), "wide": sum(r == "wide" for r, _ in seen)}
    assert counts == pi.warps_per_forward(variant, dtype) == {"narrow": 2, "wide": 6}
    c = (54, 36, 24) if variant == "S" else (144, 96, 64)
    assert [w for _, w in seen] == [c[0], c[0], c[1], c[1], c[2], c[2], 3, 3]


def make_golden(seed=GOLDEN_SEED):
    """JAX IFRNet S fp32 at t = 0.5 on the demo frames every eighth pixel,
    weights ``init_params("S", seed)``."""
    assert seed == GOLDEN_SEED
    return _demo_frames(), _jax_run("S", 1.0, seed, 0.5)[3]


def test_golden_fixture_is_current_and_port_matches_it():
    with np.load(GOLDEN) as z:
        seed, t, frames, stored = int(z["seed"]), float(z["t"]), z["frames"], z["output"]
    assert seed == GOLDEN_SEED and t == 0.5 and stored.shape == (1, 68, 120, 3)
    np.testing.assert_array_equal(frames, _demo_frames())
    np.testing.assert_allclose(make_golden(seed)[1], stored, atol=1e-6, rtol=0)
    f0, f1 = (torch.from_numpy(frames[i].astype(np.float32) / 255.0) for i in (0, 1))
    got = pi.make_model_fn(pi.init_params("S", seed), "S", device="cpu")(f0, f1, torch.tensor([t]))
    assert psnr(got.numpy(), stored) >= 40.0
    assert float(np.abs(got.numpy() - stored).max()) <= 1e-4


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    frames, out = make_golden(GOLDEN_SEED)
    np.savez_compressed(GOLDEN, seed=np.int64(GOLDEN_SEED), t=np.float32(0.5), frames=frames, output=out)
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
