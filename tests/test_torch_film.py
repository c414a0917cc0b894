"""The port's FILM against the JAX package's, on the CPU, with the same weights
(the port's numpy ``init_params`` carried across by ``nest_state_dict``).

* ``state_dict`` keys and shapes equal ``film_net_fp32.pt``'s manifest
  (``tests/fixtures/ckpt_manifests.json``, 82 tensors, 34,436,667 values).
* every ``stage_*`` at ``[1, 128, 128, 3]`` fp32, fed the JAX stage's own
  inputs, entry by entry: max abs error <= 5e-4 x (1 + the entry's largest
  magnitude), the tolerance the JAX model is held to against the reference
  (``tests/test_model_parity_film.py``). Convolutions sum in another order
  than XLA:CPU's. The port's ``stage_warp`` concatenates each level in the
  reference's channel order, JAX keeps two groups; the test reorders JAX's.
* ``apply`` >= 40 dB at (128, 128) and at the odd (68, 92); bf16 >= 35 dB
  against JAX fp32.
* a TorchScript archive of a FILM state dict loads through
  ``load_checkpoint_file``, and the node runs from it.
* the JAX golden fixture (``tests/fixtures/torch_port_film_golden.npz``) is
  regenerated with JAX and must be unchanged; the port matches it.

JAX's ``apply`` is the composition of its stages (``film.py:337-343``); each
stage is jitted once here, and the chain of them serves as JAX ``apply`` at
every shape, so XLA compiles each stage once per shape.

Run ``python tests/test_torch_film.py`` to rewrite the fixture.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.models import film as jf
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch.core import config as port_config
from comfyui_frame_interpolation_tpu_torch.models import film as pf
from comfyui_frame_interpolation_tpu_torch.nodes.vfi_nodes import FILM_VFI
from comfyui_frame_interpolation_tpu_torch.utils.ckpt import (
    is_torchscript_archive,
    load_checkpoint_file,
    params_from_jax,
)
from torch_offline import no_downloads  # noqa: F401  (autouse: no download leaves the machine)
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port_film_golden.npz")
GOLDEN_SEED = 1234
HW = (128, 128)
ODD_HW = (68, 92)
TOL = 5e-4

_jax_stages = {
    "pyramid": jax.jit(jf.stage_pyramid),
    "features": jax.jit(jf.stage_features),
    "flow": jax.jit(jf.stage_flow, static_argnums=2),
    "warp": jax.jit(jf.stage_warp, static_argnums=4),
    "fuse": jax.jit(jf.stage_fuse),
}


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def _frames(seed, hw):
    rng = np.random.default_rng(seed)
    return rng.random((1, *hw, 3), dtype=np.float32), rng.random((1, *hw, 3), dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _params(seed):
    sd = pf.init_params(seed)
    return sd, to_jax_tree(nest_state_dict(sd))


@functools.lru_cache(maxsize=None)
def _jax_run(seed, hw):
    """JAX's stage inputs and outputs on the frames and weights of ``seed``."""
    f0, f1 = _frames(seed, hw)
    _, jp = _params(seed)
    pyr = _jax_stages["pyramid"](jnp.asarray(f0), jnp.asarray(f1))
    feat = _jax_stages["features"](jp, pyr)
    fwd, bwd = _jax_stages["flow"](jp, feat, 1)
    aligned = _jax_stages["warp"](pyr, feat, fwd, bwd, 1)
    out = _jax_stages["fuse"](jp, aligned)
    to_np = lambda xs: [np.asarray(x) for x in xs]  # noqa: E731
    return dict(
        frames=(f0, f1), pyr=to_np(pyr), feat=to_np(feat), fwd=to_np(fwd), bwd=to_np(bwd),
        aligned=[to_np(level) for level in aligned], out=np.asarray(out),
    )


def _net(seed, dtype=torch.float32):
    return pf._load(_params(seed)[0], dtype, "cpu")


def _nchw(xs):
    return [torch.from_numpy(np.array(x)).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last) for x in xs]


def _nhwc(xs):
    return [x.permute(0, 2, 3, 1).numpy() for x in xs]


def _reference_order(level):
    """JAX's two groups (``[img0, img1, bwd, fwd]``, ``[feat0, feat1]``) as
    the reference's concat ``[img0, feat0, img1, feat1, bwd, fwd]``."""
    smalls, feats = level
    f = feats.shape[-1] // 2
    return np.concatenate([smalls[..., :3], feats[..., :f], smalls[..., 3:6], feats[..., f:], smalls[..., 6:]], -1)


def _assert_entries_close(got, ref, what):
    assert len(got) == len(ref), what
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, (what, i, g.shape, r.shape)
        err = float(np.abs(g - r).max())
        assert err <= TOL * (1.0 + float(np.abs(r).max())), (what, i, err)


def test_state_dict_equals_film_checkpoint_manifest():
    path = os.path.join(os.path.dirname(__file__), "fixtures", "ckpt_manifests.json")
    with open(path) as f:
        manifest = json.load(f)["manifests"]["film_net_fp32.pt"]
    assert manifest["container"] == "torchscript"
    with torch.device("meta"):
        sd = pf.FILMNet().state_dict()
    assert len(sd) == 82
    assert {k: list(v.shape) for k, v in sd.items()} == manifest["tensors"]
    assert sum(int(np.prod(s)) for s in manifest["tensors"].values()) == 34_436_667


def test_init_params_is_seeded():
    sd = pf.init_params(0)
    assert all(torch.equal(sd[k], v) for k, v in pf.init_params(0).items())
    key = "fuse.convs.0.1.0.weight"
    assert not torch.equal(sd[key], pf.init_params(1)[key])
    assert float(sd[key].abs().max()) <= 1.0 / np.sqrt(2442 * 9)
    assert float(sd["fuse.output_conv.bias"].abs().max()) <= 1.0 / np.sqrt(64)
    assert all(v.dtype == torch.float32 for v in sd.values())


def test_params_from_jax_round_trips_the_weights():
    sd = pf.init_params(0)
    back = params_from_jax(nest_state_dict(sd))
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    pf.make_model_fn(back, device="cpu")  # loads with strict=True


def test_stage_pyramid_matches_jax():
    run = _jax_run(0, HW)
    f0, f1 = run["frames"]
    got = pf.stage_pyramid(torch.from_numpy(f0), torch.from_numpy(f1))
    _assert_entries_close(_nhwc(got), run["pyr"], "pyramid")


def test_stage_features_matches_jax():
    run = _jax_run(0, HW)
    with torch.inference_mode():
        got = pf.stage_features(_net(0), _nchw(run["pyr"]))
    _assert_entries_close(_nhwc(got), run["feat"], "features")


def test_stage_flow_matches_jax():
    run = _jax_run(0, HW)
    with torch.inference_mode():
        fwd, bwd = pf.stage_flow(_net(0), _nchw(run["feat"]), 1)
    _assert_entries_close(_nhwc(fwd), run["fwd"], "fwd_flow")
    _assert_entries_close(_nhwc(bwd), run["bwd"], "bwd_flow")


def test_stage_warp_matches_jax():
    run = _jax_run(0, HW)
    got = pf.stage_warp(_nchw(run["pyr"]), _nchw(run["feat"]), _nchw(run["fwd"]), _nchw(run["bwd"]), 1)
    _assert_entries_close(_nhwc(got), [_reference_order(level) for level in run["aligned"]], "aligned")


def test_stage_fuse_matches_jax():
    run = _jax_run(0, HW)
    with torch.inference_mode():
        got = pf.stage_fuse(_net(0), _nchw([_reference_order(level) for level in run["aligned"]]))
    _assert_entries_close(_nhwc([got]), [run["out"]], "fuse")


@pytest.mark.parametrize("hw", [HW, ODD_HW])
def test_apply_matches_jax_fp32(hw):
    run = _jax_run(0, hw)
    f0, f1 = run["frames"]
    with torch.inference_mode():
        got = pf.apply(_net(0), torch.from_numpy(f0), torch.from_numpy(f1))
    assert got.dtype == torch.float32 and tuple(got.shape) == run["out"].shape == (1, *hw, 3)
    p = psnr(got.numpy(), run["out"])
    print(f"FILM apply {hw}: port vs JAX {p:.2f} dB, max abs err {np.abs(got.numpy() - run['out']).max():.3g}")
    assert p >= 40.0


def test_apply_bf16_vs_jax_fp32():
    run = _jax_run(0, HW)
    f0, f1 = (torch.from_numpy(f).to(torch.bfloat16) for f in run["frames"])
    with torch.inference_mode():
        got = pf.apply(_net(0, torch.bfloat16), f0, f1)
    assert got.dtype == torch.bfloat16
    p = psnr(got.float().numpy(), run["out"])
    print(f"FILM apply bf16 vs JAX fp32: {p:.2f} dB")
    assert p >= 35.0


def test_make_model_fn_clamps_and_returns_f32():
    run = _jax_run(0, HW)
    f0, f1 = (torch.from_numpy(f) for f in run["frames"])
    got = pf.make_model_fn(_params(0)[0], dtype=torch.bfloat16, device="cpu")(f0, f1, torch.tensor([0.5]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, *HW, 3)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    assert psnr(got.numpy(), np.clip(run["out"], 0.0, 1.0)) >= 35.0


def test_torchscript_checkpoint_loads_and_drives_the_node(tmp_path, monkeypatch):
    """A ``torch.jit.script``-saved module holding a FILM state dict (the
    container of ``film_net_fp32.pt``) loads through ``torch.jit.load``; a
    plain ``torch.save`` container still loads; the node runs from the file."""
    ckpts = tmp_path / "ckpts"
    (ckpts / "film").mkdir(parents=True)
    sd = pf.init_params(3)
    torch.jit.script(pf._load(sd, torch.float32, "cpu")).save(str(ckpts / "film" / "film_net_fp32.pt"))
    torch.save(sd, str(ckpts / "film" / "plain.pth"))
    monkeypatch.setenv("CFI_TORCH_CONFIG", str(tmp_path / "config.yaml"))
    (tmp_path / "config.yaml").write_text(f"ckpts_path: {ckpts}\n")
    port_config.load_config.cache_clear()
    try:
        assert is_torchscript_archive(str(ckpts / "film" / "film_net_fp32.pt"))
        assert not is_torchscript_archive(str(ckpts / "film" / "plain.pth"))
        for name in ("film_net_fp32.pt", "plain.pth"):
            loaded = load_checkpoint_file(str(ckpts / "film" / name))
            assert loaded.keys() == sd.keys(), name
            assert all(torch.equal(loaded[k], sd[k]) for k in sd), name
        frames = np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32)
        (from_file,) = FILM_VFI().vfi("film_net_fp32.pt", frames, device="cpu")
        (from_params,) = FILM_VFI().vfi("film_net_fp32.pt", frames, params=sd, device="cpu")
        torch.testing.assert_close(from_file, from_params, rtol=0, atol=0)
    finally:
        port_config.load_config.cache_clear()


def make_golden(seed=GOLDEN_SEED):
    """JAX FILM fp32 output on the frames and weights of ``seed``."""
    return _jax_run(seed, HW)["out"]


def test_golden_fixture_is_current_and_port_matches_it():
    with np.load(GOLDEN) as z:
        seed, stored = int(z["seed"]), z["output"]
    assert seed == GOLDEN_SEED and stored.shape == (1, *HW, 3)
    np.testing.assert_allclose(make_golden(seed), stored, atol=1e-6, rtol=0)
    f0, f1 = _frames(seed, HW)
    with torch.inference_mode():
        got = pf.apply(_net(seed), torch.from_numpy(f0), torch.from_numpy(f1))
    assert psnr(got.numpy(), stored) >= 40.0


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(GOLDEN, seed=np.int64(GOLDEN_SEED), output=make_golden(GOLDEN_SEED))
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
