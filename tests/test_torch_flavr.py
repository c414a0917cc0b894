"""The port's FLAVR against the JAX package's, on the CPU, with the same weights
(the port's numpy ``init_params`` carried across by ``nest_state_dict``) and
the same numpy inputs.

* ``state_dict`` keys and shapes equal the ``FLAVR_2x.pth`` manifest without
  its ``module.`` prefix (59 tensors); seeding is deterministic; the output
  count comes from ``outconv.1.weight``.
* ``conv3d`` and ``conv_transpose3d`` (the stem's strides ``(1, 2, 2)`` and
  padding ``(1, 3, 3)``, the decoder's kernel ``(3, 4, 4)``) within 1e-5.
* ``apply`` with three outputs and ``make_model_fn`` in fp32 within 1e-4, bf16
  against JAX fp32 >= 40 dB, at the golden's padded shape (80x128).
* The JAX golden (``tests/fixtures/torch_port_flavr_golden.npz``:
  ``demo_frames/seq/0-3.png`` every eighth pixel, 68x120, edge-padded to
  80x128 and centred as the node pads it, cropped back; weights from the
  seed) is regenerated with JAX and must be unchanged; the port matches it
  at >= 40 dB.

JAX ``flavr.apply`` is jitted with the weights as an argument. Run ``python
tests/test_torch_flavr.py`` to rewrite the fixture.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.models import common as jc
from comfyui_frame_interpolation_tpu.models import flavr as jf
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch.models import common as pc
from comfyui_frame_interpolation_tpu_torch.models import flavr as pf
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "torch_port_flavr_golden.npz")
GOLDEN_SEED = 2468
HW, PAD = (68, 120), ((6, 6), (4, 4))  # edge pad to 80x128, centred


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def test_state_dict_equals_the_manifest_without_module():
    with open(os.path.join(ROOT, "tests", "fixtures", "ckpt_manifests.json")) as f:
        entry = json.load(f)["manifests"]["FLAVR_2x.pth"]
    assert entry["container"] == "state_dict+module"
    want = {k.removeprefix("module."): v for k, v in entry["tensors"].items()}
    with torch.device("meta"):
        sd = pf.FLAVR().state_dict()
    assert {k: list(v.shape) for k, v in sd.items()} == want
    a, b, c = pf.init_params(0), pf.init_params(0), pf.init_params(1)
    assert a.keys() == sd.keys() and len(a) == 59
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.stem.0.weight"], c["encoder.stem.0.weight"])
    assert pf.infer_n_outputs(a) == 1 and pf.infer_n_outputs(pf.init_params(0, n_outputs=3)) == 3


@pytest.mark.parametrize("k,stride,padding", [((3, 7, 7), (1, 2, 2), (1, 3, 3)), (3, 1, 1), (1, (1, 2, 2), 0)])
def test_conv3d(k, stride, padding):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 10, 14, 3)).astype(np.float32)  # NDHWC
    ks = (k,) * 3 if isinstance(k, int) else k
    w = (rng.standard_normal((5, 3, *ks)) * 0.2).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    ref = np.asarray(jc.conv3d(jnp.asarray(x), {"weight": w, "bias": b}, stride=stride, padding=padding))
    got = pc.conv3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3), torch.from_numpy(w), torch.from_numpy(b), stride, padding)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("stride,padding", [((1, 2, 2), 1), ((1, 2, 2), (1, 1, 1)), (1, 0)])
def test_conv_transpose3d(stride, padding):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 5, 7, 6)).astype(np.float32)
    w = (rng.standard_normal((6, 4, 3, 4, 4)) * 0.2).astype(np.float32)  # IODHW
    b = rng.standard_normal(4).astype(np.float32)
    ref = np.asarray(jc.conv_transpose3d(jnp.asarray(x), {"weight": w, "bias": b}, stride=stride, padding=padding))
    got = pc.conv_transpose3d(torch.from_numpy(x).permute(0, 4, 1, 2, 3), torch.from_numpy(w), torch.from_numpy(b), stride, padding)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), ref, atol=1e-5, rtol=0)


_jax_apply = jax.jit(jf.apply, static_argnums=2)


def _demo_frames():
    from PIL import Image

    imgs = [np.asarray(Image.open(os.path.join(ROOT, "demo_frames", "seq", f"{i}.png")).convert("RGB")) for i in range(4)]
    return np.stack(imgs)[:, ::8, ::8]


def _padded_clip(frames_u8):
    """The four frames as floats, edge-padded as the node pads them, as one
    NDHWC clip ``[1, 4, 80, 128, 3]``."""
    x = np.pad(frames_u8.astype(np.float32) / 255.0, ((0, 0), *PAD, (0, 0)), mode="edge")
    return x[None]


@functools.lru_cache(maxsize=None)
def _params(seed, n_outputs=1):
    sd = pf.init_params(seed, n_outputs)
    return sd, to_jax_tree(nest_state_dict(sd))


def test_apply_three_outputs_matches_jax():
    clip = _padded_clip(_demo_frames())
    sd, jp = _params(0, 3)
    ref = [np.asarray(o) for o in _jax_apply(jp, jnp.asarray(clip), 3)]
    with torch.inference_mode():
        got = pf.apply(pf._load(sd, torch.float32, "cpu"), torch.from_numpy(clip).permute(0, 4, 1, 2, 3))
    assert len(got) == 3
    for g, r in zip(got, ref):
        assert float(np.abs(g.permute(0, 2, 3, 1).numpy() - r).max()) <= 1e-4


def test_make_model_fn_matches_jax_fp32_and_bf16():
    clip = _padded_clip(_demo_frames())
    sd, jp = _params(0)
    ref = np.asarray(_jax_apply(jp, jnp.asarray(clip), 1)[0])
    f = [torch.from_numpy(clip[:, i]) for i in range(4)]
    got = pf.make_model_fn(sd, device="cpu")(*f)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 80, 128, 3)
    assert float(np.abs(got.numpy() - ref).max()) <= 1e-4
    got16 = pf.make_model_fn(sd, dtype=torch.bfloat16, device="cpu")(*f)
    assert got16.dtype == torch.float32 and psnr(got16.numpy(), ref) >= 40.0


def make_golden(seed=GOLDEN_SEED):
    """JAX FLAVR fp32 on the four demo frames every eighth pixel, padded as
    the node pads them and cropped back, weights ``init_params(seed)``."""
    frames = _demo_frames()
    out = np.asarray(_jax_apply(_params(seed)[1], jnp.asarray(_padded_clip(frames)), 1)[0])
    (t, _), (l, _) = PAD
    return frames, out[:, t : t + HW[0], l : l + HW[1]]


def test_golden_fixture_is_current_and_port_matches_it():
    with np.load(GOLDEN) as z:
        seed, frames, stored = int(z["seed"]), z["frames"], z["output"]
    assert seed == GOLDEN_SEED and stored.shape == (1, *HW, 3)
    np.testing.assert_array_equal(frames, _demo_frames())
    np.testing.assert_allclose(make_golden(seed)[1], stored, atol=1e-6, rtol=0)
    from comfyui_frame_interpolation_tpu_torch.nodes.vfi_nodes import FLAVR_VFI

    (got,) = FLAVR_VFI().vfi("FLAVR_2x.pth", frames.astype(np.float32) / 255.0, params=pf.init_params(seed), device="cpu")
    assert tuple(got.shape) == (5, *HW, 3)  # one window: frames 0 and 1, the mid frame, frames 2 and 3
    assert psnr(got[2:3].numpy(), stored) >= 40.0
    assert float(np.abs(got[2:3].numpy() - stored).max()) <= 1e-4


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    frames, out = make_golden(GOLDEN_SEED)
    np.savez_compressed(GOLDEN, seed=np.int64(GOLDEN_SEED), frames=frames, output=out)
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
