"""The port's AMT against the JAX package's, on the CPU, with the same weights
(the port's numpy ``init_params`` carried across by ``nest_state_dict``) and
the same numpy inputs.

* ``state_dict`` keys and shapes equal the ``amt-s.pth`` manifest (213
  tensors); L and G have the keys that the JAX ``apply`` reads (the model
  tests run JAX on them); seeding is deterministic.
* The correlation lookup (``ops.bidir_corr.BidirCorr``) against JAX's
  ``_BidirCorr`` on a 12x20 map (the coarsest pooled level 1x2) and a
  3x5 one (two empty pooled levels) at
  fractional coordinates inside, windows that overlap the edge, windows
  wholly outside on every side and exact integers, within 1e-5 of the
  magnitude, in one band and in many; the tap order (outer index = x offset)
  on a one-hot target, exactly; bf16 features give the f32 lookup of their
  values, rounded once.
* ``make_model_fn`` end to end on the demo frames every eighth pixel,
  cropped to 64x112 (multiples of 16, as the node pads), for S, L and G:
  fp32 within 1e-4 of JAX fp32, bf16 >= 40 dB against JAX fp32.
* ``warps_per_forward`` equals the warps a forward makes (6 wide: C = 44,
  32, 20 for S; 2 K1 over ``[N * num_flows, H, W, 3]``).
* The JAX golden (``tests/fixtures/torch_port_amt_golden.npz``: those frames,
  S, t = 0.5, weights from the seed) is regenerated with JAX and must be
  unchanged; the port matches it at >= 40 dB.

The model runs go through one jitted function with the weights as an
argument, compiled once per variant at the golden's shape. Run
``python tests/test_torch_amt.py`` to rewrite the fixture.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.models import amt as ja
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch.models import amt as pa
from comfyui_frame_interpolation_tpu_torch.models import ifrnet as pi
from comfyui_frame_interpolation_tpu_torch.ops import bidir_corr
from comfyui_frame_interpolation_tpu_torch.ops.cuda import warp_kernel
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "fixtures", "torch_port_amt_golden.npz")
GOLDEN_SEED = 2026
CKPT = {"S": "amt-s.pth", "L": "amt-l.pth", "G": "amt-g.pth"}


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


# ---- a. layout and weights -------------------------------------------------------


def test_state_dict_equals_the_manifest():
    with open(os.path.join(ROOT, "tests", "fixtures", "ckpt_manifests.json")) as f:
        want = json.load(f)["manifests"]["amt-s.pth"]["tensors"]
    s = pa.init_params("S", 0)
    assert {k: list(v.shape) for k, v in s.items()} == want and len(s) == 213
    big, g = pa.init_params("L", 0), pa.init_params("G", 0)
    assert tuple(big["comb_block.0.weight"].shape) == (30, 15, 7, 7) and "update2.convc2.weight" in big
    assert "feat_encoder.layer3_2.1.conv2.weight" in g and "update2_high.gru.0.weight" in g and "update2.conv.weight" not in g
    assert tuple(g["encoder.pyramid1.0.0.weight"].shape) == (84, 3, 7, 7)


def test_init_params_is_seeded():
    a, b, c = pa.init_params("S", 0), pa.init_params("S", 0), pa.init_params("S", 1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["update4.convc1.weight"], c["update4.convc1.weight"])
    assert torch.equal(a["comb_block.1.weight"], torch.full((18,), 0.25))


# ---- b. the correlation lookup ----------------------------------------------------------


def _corr_case(seed=1, b=2, h=12, w=20, c=8):
    """Feature maps and, per direction, coordinates: fractional inside,
    windows overlapping each edge, windows wholly outside on every side
    (at level 0 and at the 1x2 coarsest level), exact integers."""
    rng = np.random.default_rng(seed)
    f0, f1 = (rng.standard_normal((b, h, w, c)).astype(np.float32) for _ in range(2))
    coords = []
    for _ in range(2):
        xy = np.stack([rng.uniform(-2, w + 1, (b, h, w)), rng.uniform(-2, h + 1, (b, h, w))], -1).astype(np.float32)
        special = [[-3.5, 4.25], [w + 2.5, 3.0], [5.0, -3.75], [7.5, h + 2.25], [-9.5, -9.5], [w + 12.0, h + 13.0],
                   [-60.0, 5.0], [6.0, 90.0],  # outside at every level
                   [4.0, 7.0], [0.0, 0.0]]  # integers
        xy.reshape(b, h * w, 2)[:, : len(special)] = special
        coords.append(xy)
    return f0, f1, coords


@functools.lru_cache(maxsize=None)
def _jax_lookup(hw):
    """``_corr_case`` at ``hw`` and JAX's lookup of it."""
    f0, f1, (c0, c1) = _corr_case(h=hw[0], w=hw[1])
    ref = ja._BidirCorr(jnp.asarray(f0), jnp.asarray(f1)).lookup(jnp.asarray(c0), jnp.asarray(c1))
    return f0, f1, (c0, c1), [np.asarray(r) for r in ref]


@pytest.mark.parametrize("band,hw", [(None, (12, 20)), (1000, (12, 20)), (None, (3, 5))])
def test_corr_lookup_matches_jax(band, hw, monkeypatch):
    """``hw`` (3, 5): levels 2 and 3 pool to empty maps, which read as zeros."""
    if band is not None:  # many bands of a few queries each
        monkeypatch.setattr(bidir_corr, "BAND_ELEMENTS", band)
    f0, f1, (c0, c1), ref = _jax_lookup(hw)
    got = bidir_corr.BidirCorr(_nchw(f0), _nchw(f1)).lookup(torch.from_numpy(c0), torch.from_numpy(c1))
    for g, r, d in zip(got, ref, ("0->1", "1->0")):
        assert g.dtype == torch.float32 and tuple(g.shape) == (2, 196, *hw)
        _close(g.permute(0, 2, 3, 1).numpy(), r, f"lookup {d}", 1e-5)
    # the wholly outside windows give zeros at every level
    assert float(got[0].flatten(2)[:, :, 6:8].abs().max()) == 0.0


def test_corr_tap_order_is_x_major():
    """A one-hot target: query (x, y) at integer coordinates sees the target
    pixel (x + dx, y + dy) at level 0 in channel ``(dx + 3) * 7 + (dy + 3)``."""
    c = 4
    f1 = np.zeros((1, 16, 16, c), np.float32)
    f1[0, 9, 6, 2] = 1.0  # the target at x = 6, y = 9
    f0 = np.zeros((1, 16, 16, c), np.float32)
    f0[..., 2] = 1.0
    xy = np.stack(np.meshgrid(np.arange(16), np.arange(16), indexing="xy"), -1)[None].astype(np.float32)
    got, _ = bidir_corr.BidirCorr(_nchw(f0), _nchw(f1)).lookup(torch.from_numpy(xy), torch.from_numpy(xy))
    level0 = got[0, :49].numpy()  # [49, 16, 16]
    want = np.zeros_like(level0)
    for dx in range(-3, 4):
        for dy in range(-3, 4):
            want[(dx + 3) * 7 + (dy + 3), 9 - dy, 6 - dx] = 1.0 / np.sqrt(c)
    np.testing.assert_array_equal(level0, want)


def test_corr_lookup_bf16_is_the_f32_lookup_rounded():
    f0, f1, (c0, c1) = _corr_case(seed=2)
    a, b = _nchw(f0).bfloat16(), _nchw(f1).bfloat16()
    got = bidir_corr.BidirCorr(a, b).lookup(torch.from_numpy(c0), torch.from_numpy(c1))
    ref = bidir_corr.BidirCorr(a.float(), b.float()).lookup(torch.from_numpy(c0), torch.from_numpy(c1))
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16 and torch.equal(g, r.bfloat16())


def test_jax_bf16_coordinates_lose_their_fraction():
    """The known difference (``ROADMAP.md`` Queue 3): JAX builds AMT's
    coordinates in the images' dtype, so in bf16 every x from 128 up (1080p:
    W/8 = 240) loses its fraction and the windows move by up to half a
    pixel; the port keeps them in f32 in every dtype. On a map 240 wide at
    1080p's x range, JAX's lookup at bf16-rounded end points against the
    same at f32 end points, which the port matches within 1e-5."""
    rng = np.random.default_rng(4)
    f0, f1 = (rng.standard_normal((1, 6, 240, 8)).astype(np.float32) for _ in range(2))
    xy = np.stack([rng.uniform(128, 239, (1, 6, 240)), rng.uniform(0, 5, (1, 6, 240))], -1).astype(np.float32)
    jc = ja._BidirCorr(jnp.asarray(f0), jnp.asarray(f1))
    ref = np.asarray(jc.lookup(jnp.asarray(xy), jnp.asarray(xy))[0])
    rounded = np.asarray(jc.lookup(jnp.asarray(xy).astype(jnp.bfloat16), jnp.asarray(xy))[0])
    got = bidir_corr.BidirCorr(_nchw(f0), _nchw(f1)).lookup(torch.from_numpy(xy), torch.from_numpy(xy))[0]
    _close(got.permute(0, 2, 3, 1).numpy(), ref, "f32 end points", 1e-5)
    err = float(np.abs(rounded - ref).max())
    print(f"JAX bf16 end points at x in [128, 239): max abs error {err:.4f} of a {np.abs(ref).max():.4f} lookup")
    assert err > 0.05 * np.abs(ref).max()


# ---- c. the model function -----------------------------------------------------------


def _demo_frames():
    """``anime0.png`` and ``anime1.png`` every eighth pixel, cropped to
    64x112, uint8 ``[2, 1, 64, 112, 3]``."""
    from PIL import Image

    imgs = [np.asarray(Image.open(os.path.join(ROOT, "demo_frames", f"anime{i}.png")).convert("RGB")) for i in (0, 1)]
    return np.stack(imgs)[:, None, ::8, ::8][:, :, 2:66, 4:116]


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jax_fn(p, f0, f1, t, variant, num_flows):
    return ja.apply(p, f0, f1, t, variant=variant, num_flows=num_flows)


@functools.lru_cache(maxsize=None)
def _jax_run(variant, seed, t):
    frames = _demo_frames().astype(np.float32) / 255.0
    sd = pa.init_params(variant, seed)
    t = np.asarray([t], np.float32)
    nf = pa.CKPT_CONFIGS[CKPT[variant]]["num_flows"]
    out = _jax_fn(to_jax_tree(nest_state_dict(sd)), jnp.asarray(frames[0]), jnp.asarray(frames[1]), jnp.asarray(t), variant, nf)
    return frames, sd, t, np.asarray(out)


@pytest.mark.parametrize("variant", ["S", "L", "G"])
def test_make_model_fn_matches_jax_fp32_and_bf16(variant):
    frames, sd, t, want = _jax_run(variant, 0, 0.3)
    f0, f1, tt = torch.from_numpy(frames[0]), torch.from_numpy(frames[1]), torch.from_numpy(t)
    got = pa.make_model_fn(sd, CKPT[variant], device="cpu")(f0, f1, tt)
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 64, 112, 3)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4
    got16 = pa.make_model_fn(sd, CKPT[variant], dtype=torch.bfloat16, device="cpu")(f0, f1, tt)
    assert psnr(got16.numpy(), want) >= 40.0


@pytest.mark.parametrize("variant,dtype", [("S", torch.float32), ("S", torch.bfloat16), ("L", torch.bfloat16), ("G", torch.bfloat16)])
def test_launch_counts_equal_a_forward(variant, dtype, monkeypatch):
    """The warps of one forward (all through ``ifrnet.warp_nchw``), routed by
    their planes as the card would route them, against
    ``warps_per_forward``: both frames' features at three levels, then both
    frames over every flow of the batch."""
    seen = []
    real = pi.warp

    def spy(img, flow, *args):
        planes = img.permute(0, 3, 1, 2)
        seen.append((warp_kernel.route(planes.shape, planes.stride(), planes.dtype), img.shape[-1], img.shape[0]))
        return real(img, flow, *args)

    monkeypatch.setattr(pi, "warp", spy)
    f = [torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(i)) for i in range(2)]
    pa.make_model_fn(pa.init_params(variant, 0), CKPT[variant], dtype=dtype, device="cpu")(*f, torch.tensor([0.25, 0.75]))
    counts = {"narrow": sum(r == "tiled" for r, _, _ in seen), "wide": sum(r == "wide" for r, _, _ in seen)}
    assert counts == pa.warps_per_forward(variant, dtype) == {"narrow": 2, "wide": 6}
    c0, c1, c2, _ = pa._VARIANTS[variant][0]
    nf = pa.CKPT_CONFIGS[CKPT[variant]]["num_flows"]
    assert [(w, n) for _, w, n in seen] == [(c2, 2), (c2, 2), (c1, 2), (c1, 2), (c0, 2), (c0, 2), (3, 2 * nf), (3, 2 * nf)]


# ---- d. the golden ----------------------------------------------------------------------------


def make_golden(seed=GOLDEN_SEED):
    """JAX AMT-S fp32 at t = 0.5 on the demo frames every eighth pixel
    cropped to 64x112, weights ``init_params("S", seed)``."""
    assert seed == GOLDEN_SEED
    return _demo_frames(), _jax_run("S", seed, 0.5)[3]


def test_golden_fixture_is_current_and_port_matches_it():
    with np.load(GOLDEN) as z:
        seed, t, frames, stored = int(z["seed"]), float(z["t"]), z["frames"], z["output"]
    assert seed == GOLDEN_SEED and t == 0.5 and stored.shape == (1, 64, 112, 3)
    np.testing.assert_array_equal(frames, _demo_frames())
    np.testing.assert_allclose(make_golden(seed)[1], stored, atol=1e-6, rtol=0)
    f0, f1 = (torch.from_numpy(frames[i].astype(np.float32) / 255.0) for i in (0, 1))
    got = pa.make_model_fn(pa.init_params("S", seed), "amt-s.pth", device="cpu")(f0, f1, torch.tensor([t]))
    assert psnr(got.numpy(), stored) >= 40.0
    assert float(np.abs(got.numpy() - stored).max()) <= 1e-4


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    frames, out = make_golden(GOLDEN_SEED)
    np.savez_compressed(GOLDEN, seed=np.int64(GOLDEN_SEED), t=np.float32(0.5), frames=frames, output=out)
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
