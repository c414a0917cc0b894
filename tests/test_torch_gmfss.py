"""The port's GMFSS Fortuna against the JAX package's, on the CPU, with the
same weights (the port's numpy ``init_params`` carried across by
``nest_state_dict``) and the same numpy inputs.

* ``state_dict`` keys and shapes equal the four base manifests
  (``tests/fixtures/ckpt_manifests.json``, 289 tensors), each file's keys
  under its prefix; the union layout is the base one with the 9-channel
  ``residual_model_head0`` and a RIFE 4.6 ``ifnet``; seeding is
  deterministic.
* each part (normalisations, CNN encoder, windows and their attention,
  transformer, position embedding, both correlation softmaxes, flow
  attention, convex upsampling, GMFlow, metric net, feature net, GridNet)
  against its JAX function, fp32: max abs error <= 2e-5 x (1 + the largest
  magnitude), 1e-4 for the softmax-expected flows.
* ``reuse`` entry by entry: flows (pixels, from the global softmax, which
  amplifies f32 rounding at ambiguous matches) with the output tolerances
  of ``tests/test_model_parity_gmfss.py`` (mean <= 2e-4, 99.9 % quantile
  <= 5e-3, max <= 5e-2); metrics and features 2e-5 x (1 + magnitude).
  The flows and metrics also at ``scale`` 0.5, with the flows' tolerances.
* ``inference`` fed JAX's own ``reuse`` outputs, base and union: atol 2e-4.
* ``apply``, base and union, at 128x192 and at the golden's 270x480 (not a
  multiple of 64): mean <= 2e-4, 99.9 % quantile <= 5e-3, max <= 5e-2.
* bf16 against JAX fp32: >= 40 dB.
* the JAX golden fixture (``tests/fixtures/torch_port_gmfss_golden.npz``,
  base and union on ``demo_frames/anime0.png`` and ``anime1.png`` taken
  every other pixel, 270x480, t = 0.5) is regenerated with JAX and must be
  unchanged; the port matches it at >= 40 dB.

JAX's ``apply`` is ``inference`` of ``reuse`` on the padded frames
(``gmfss.py:637-656``); both halves are jitted once each per shape here, and
``reuse`` reads only the flow, metric and feature nets, which ``init_params``
draws first, so base and union of one seed share one JAX ``reuse`` run.

Run ``python tests/test_torch_gmfss.py`` to rewrite the fixture.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.models import gmfss as jg
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch.models import gmfss as pg
from comfyui_frame_interpolation_tpu_torch.utils.ckpt import params_from_jax
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port_gmfss_golden.npz")
DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "demo_frames")
GOLDEN_SEED = 1234
HW = (128, 192)
GOLDEN_HW = (270, 480)
TOL = 2e-5
_FILES = {
    "flownet": "GMFSS_fortuna_flownet.pkl",
    "feat_ext": "GMFSS_fortuna_feat.pkl",
    "metricnet": "GMFSS_fortuna_metric.pkl",
    "fusionnet": "GMFSS_fortuna_fusionnet.pkl",
}
_REUSE_NETS = ("flownet", "metricnet", "feat_ext")

_jax_reuse = jax.jit(jg.reuse)
_jax_infer = jax.jit(jg.inference, static_argnames="union")


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


def _pad64(x):
    n, h, w, c = x.shape
    return np.pad(x, ((0, 0), (0, (-h) % 64), (0, (-w) % 64), (0, 0)))


@functools.lru_cache(maxsize=None)
def _params(seed, union=False):
    sd = pg.init_params(seed, union)
    return sd, to_jax_tree(nest_state_dict(sd))


@functools.lru_cache(maxsize=None)
def _net(seed, union=False, dtype=torch.float32):
    return pg._load(_params(seed, union)[0], union, dtype, "cpu")


def demo_frames():
    """``anime0.png`` and ``anime1.png``, every other pixel: ``[2, 1, 270,
    480, 3]`` uint8."""
    from PIL import Image

    imgs = [np.asarray(Image.open(os.path.join(DEMO, f"anime{i}.png")).convert("RGB")) for i in (0, 1)]
    return np.stack(imgs)[:, None, ::2, ::2]


@functools.lru_cache(maxsize=None)
def _frames(seed, hw):
    if hw == GOLDEN_HW:
        u8 = demo_frames()
        return u8[0].astype(np.float32) / 255.0, u8[1].astype(np.float32) / 255.0
    rng = np.random.default_rng(seed)
    return rng.random((1, *hw, 3), dtype=np.float32), rng.random((1, *hw, 3), dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _jax_reuse_run(seed, hw):
    """JAX ``reuse`` on the padded frames of (seed, hw), numpy leaves."""
    f0, f1 = (_pad64(f) for f in _frames(seed, hw))
    jp = {k: _params(seed)[1][k] for k in _REUSE_NETS}
    return jax.tree_util.tree_map(np.asarray, _jax_reuse(jp, jnp.asarray(f0), jnp.asarray(f1)))


@functools.lru_cache(maxsize=None)
def _jax_apply(seed, hw, union):
    f0, f1 = (_pad64(f) for f in _frames(seed, hw))
    jp = _params(seed, union)[1]
    out = _jax_infer(jp, jnp.asarray(f0), jnp.asarray(f1), _jax_reuse_run(seed, hw), jnp.float32(0.5), union=union)
    return np.asarray(out)[:, : hw[0], : hw[1]]


def _port_apply(seed, hw, union, dtype=torch.float32):
    f0, f1 = (torch.from_numpy(f).to(dtype) for f in _frames(seed, hw))
    with torch.inference_mode():
        return pg.apply(_net(seed, union, dtype), f0, f1, torch.tensor([0.5])).float().numpy()


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, ref, what, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = float(np.abs(got - ref).max())
    assert err <= tol * (1.0 + float(np.abs(ref).max())), (what, err)


def _assert_parity(got, ref, what):
    """The output tolerances of ``tests/test_model_parity_gmfss.py``."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    print(f"{what}: mean {d.mean():.3g}, q99.9 {np.quantile(d, 0.999):.3g}, max {d.max():.3g}")
    assert d.mean() <= 2e-4 and np.quantile(d, 0.999) <= 5e-3 and d.max() <= 5e-2, what


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# ---- parameters ---------------------------------------------------------------


def test_state_dict_equals_the_base_checkpoint_manifests():
    path = os.path.join(os.path.dirname(__file__), "fixtures", "ckpt_manifests.json")
    with open(path) as f:
        manifests = json.load(f)["manifests"]
    expect = {f"{prefix}.{k}": v for prefix, name in _FILES.items() for k, v in manifests[name]["tensors"].items()}
    with torch.device("meta"):
        sd = pg.GMFSS().state_dict()
    assert len(sd) == 289 == len(expect)
    assert {k: list(v.shape) for k, v in sd.items()} == expect
    counts = {p: sum(k.startswith(p + ".") for k in sd) for p in _FILES}
    assert counts == {"flownet": 124, "feat_ext": 18, "metricnet": 14, "fusionnet": 133}


def test_union_layout_is_base_with_head0_and_rife46():
    with torch.device("meta"):
        base = {k: tuple(v.shape) for k, v in pg.GMFSS().state_dict().items()}
        union = {k: tuple(v.shape) for k, v in pg.GMFSS(union=True).state_dict().items()}
        rife46 = {f"ifnet.{k}": tuple(v.shape) for k, v in pg.rife_model.IFNet("4.6").state_dict().items()}
    head = {k for k in base if k.startswith("fusionnet.residual_model_head.")}
    head0 = {k.replace("residual_model_head.", "residual_model_head0."): v for k, v in base.items() if k in head}
    head0["fusionnet.residual_model_head0.1.weight"] = (64, 9, 3, 3)
    assert union == {**{k: v for k, v in base.items() if k not in head}, **head0, **rife46}


@pytest.mark.parametrize("union", [False, True])
def test_init_params_is_seeded_with_stated_constants(union):
    sd = pg.init_params(0, union)
    assert all(torch.equal(sd[k], v) for k, v in pg.init_params(0, union).items())
    key = "flownet.backbone.conv1.weight"
    assert not torch.equal(sd[key], pg.init_params(1, union)[key])
    assert float(sd[key].abs().max()) <= 1.0 / np.sqrt(3 * 49)
    assert torch.equal(sd["feat_ext.block1.0.weight"], torch.full((1,), pg.PRELU_INIT))
    norm = "flownet.transformer.layers.0.self_attn.norm1"
    assert torch.equal(sd[f"{norm}.weight"], torch.ones(128)) and torch.equal(sd[f"{norm}.bias"], torch.zeros(128))
    assert all(v.dtype == torch.float32 for v in sd.values())
    # the reuse nets come first in key order: one seed gives both variants the same ones
    base = pg.init_params(0)
    assert all(torch.equal(sd[k], base[k]) for k in base if k.split(".")[0] in _REUSE_NETS)
    back = params_from_jax(nest_state_dict(sd))
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    pg.make_model_fn(back, union=union, device="cpu")  # loads with strict=True


def test_make_pair_fns_loads_strictly():
    sd = pg.init_params(0)
    del sd["flownet.upsampler.2.bias"]
    with pytest.raises(RuntimeError, match="upsampler.2.bias"):
        pg.make_pair_fns(sd, device="cpu")


# ---- a-l: the parts against their JAX functions ------------------------------------


def test_a_normalisations():
    x = _rand((2, 9, 11, 6), 1, 3.0) + 1.0
    _close(pg.instance_norm(_nchw(x)).permute(0, 2, 3, 1), jg._instance_norm(jnp.asarray(x)), "instance_norm")
    tok = _rand((2, 7, 128), 2, 2.0)
    node = {"weight": _rand((128,), 3), "bias": _rand((128,), 4)}
    norm = torch.nn.LayerNorm(128)
    norm.load_state_dict({k: _t(v) for k, v in node.items()})
    with torch.inference_mode():
        _close(pg._layer_norm(_t(tok), norm), jg._layer_norm(jnp.asarray(tok), node), "layer_norm")


def test_b_cnn_encoder():
    x = _rand((2, 64, 96, 3), 5)
    ref = jg._cnn_encoder(_params(0)[1]["flownet"]["backbone"], jnp.asarray(x))[::-1]
    with torch.inference_mode():
        got = _net(0).flownet.backbone(_nchw(x))
    assert len(got) == 2
    for g, r in zip(got, ref):
        _close(g.permute(0, 2, 3, 1), r, "cnn_encoder")


@pytest.mark.parametrize("k,hw", [(2, (8, 12)), (8, (16, 24))])
def test_c_windows_and_attention(k, hw):
    x = _rand((2, *hw, 5), 6)
    np.testing.assert_array_equal(pg._split_windows(_t(x), k).numpy(), np.asarray(jg._split_windows(jnp.asarray(x), k)))
    np.testing.assert_array_equal(pg._merge_windows(pg._split_windows(_t(x), k), k).numpy(), x)
    mask = pg._shift_window_mask(*hw, k)
    np.testing.assert_array_equal(mask, jg._shift_window_mask(*hw, k))
    q, kk, v = (_rand((2, hw[0] * hw[1], 16), s) for s in (7, 8, 9))
    for shift in (False, True):
        ref = jg._window_attention(*(jnp.asarray(a) for a in (q, kk, v)), *hw, k, shift, mask)
        got = pg._window_attention(_t(q), _t(kk), _t(v), *hw, k, shift, _t(mask))
        _close(got, ref, f"window_attention shift={shift}")


@pytest.mark.parametrize("splits,hw", [(2, (8, 12)), (8, (16, 24))])
def test_d_transformer(splits, hw):
    f0, f1 = _rand((1, *hw, 128), 10), _rand((1, *hw, 128), 11)
    ref = jg._transformer(_params(0)[1]["flownet"]["transformer"], jnp.asarray(f0), jnp.asarray(f1), splits)
    with torch.inference_mode():
        got = pg._transformer(_net(0).flownet.transformer, _t(f0), _t(f1), splits)
    for g, r in zip(got, ref):
        _close(g, r, "transformer")


@pytest.mark.parametrize("splits,hw", [(2, (8, 12)), (8, (40, 64))])
def test_e_position_embedding(splits, hw):
    np.testing.assert_array_equal(pg._position_embedding(5, 8, 64), jg._position_embedding(5, 8, 64))
    f0, f1 = _rand((1, *hw, 128), 12), _rand((1, *hw, 128), 13)
    ref = jg._add_position(jnp.asarray(f0), jnp.asarray(f1), splits)
    got = pg._add_position(_t(f0), _t(f1), splits)
    for g, r in zip(got, ref):
        _close(g, r, "add_position", tol=1e-6)


def test_f_correlation_softmax():
    f0, f1 = _rand((2, 8, 12, 128), 14, 0.3), _rand((2, 8, 12, 128), 15, 0.3)
    _close(pg._global_corr_softmax(_t(f0), _t(f1)), jg._global_corr_softmax(jnp.asarray(f0), jnp.asarray(f1)), "global", 1e-4)
    g0, g1 = _rand((2, 16, 24, 128), 16, 0.3), _rand((2, 16, 24, 128), 17, 0.3)
    ref = jg._local_corr_softmax(jnp.asarray(g0), jnp.asarray(g1), 4)
    _close(pg._local_corr_softmax(_t(g0), _t(g1), 4), ref, "local", 1e-4)


@pytest.mark.parametrize("local", [False, True])
def test_g_flow_attention(local):
    feat, flow = _rand((2, 16, 24, 128), 18), _rand((2, 16, 24, 2), 19, 4.0)
    ref = jg._flow_attn(_params(0)[1]["flownet"]["feature_flow_attn"], jnp.asarray(feat), jnp.asarray(flow), local, 1)
    with torch.inference_mode():
        got = pg._flow_attn(_net(0).flownet.feature_flow_attn, _t(feat), _t(flow), local)
    _close(got, ref, "flow_attn", 1e-4)


def test_h_convex_upsample():
    flow, feat = _rand((2, 8, 12, 2), 20, 4.0), _rand((2, 8, 12, 128), 21)
    ref = jg._convex_upsample4(_params(0)[1]["flownet"]["upsampler"], jnp.asarray(flow), jnp.asarray(feat))
    with torch.inference_mode():
        got = pg._convex_upsample4(_net(0).flownet.upsampler, _t(flow), _t(feat))
    assert tuple(got.shape) == (2, 32, 48, 2)
    _close(got, ref, "convex_upsample4")


def test_i_gmflow():
    rng = np.random.default_rng(22)
    img0, img1 = rng.random((1, 64, 96, 3), dtype=np.float32), rng.random((1, 64, 96, 3), dtype=np.float32)
    ref = np.asarray(jax.jit(jg._gmflow)(_params(0)[1]["flownet"], jnp.asarray(img0), jnp.asarray(img1)))
    with torch.inference_mode():
        got = pg._gmflow(_net(0).flownet, _nchw(img0), _nchw(img1)).numpy()
    _assert_parity(got, ref, "gmflow flow")


def test_j_metric_net_and_consistency():
    rng = np.random.default_rng(23)
    img0, img1 = rng.random((2, 32, 48, 3), dtype=np.float32), rng.random((2, 32, 48, 3), dtype=np.float32)
    fwd, bwd = _rand((2, 32, 48, 2), 24, 3.0), _rand((2, 32, 48, 2), 25, 3.0)
    ref_occ = jg._fb_consistency(jnp.asarray(fwd), jnp.asarray(bwd))
    got_occ = pg._fb_consistency(_t(fwd), _t(bwd))
    for g, r in zip(got_occ, ref_occ):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    ref = jg._metricnet(_params(0)[1]["metricnet"], *(jnp.asarray(a) for a in (img0, img1, fwd, bwd)))
    with torch.inference_mode():
        got = pg._metricnet(_net(0).metricnet, *(_t(a) for a in (img0, img1, fwd, bwd)))
    for g, r in zip(got, ref):
        _close(g, r, "metricnet")


def test_k_feature_net():
    x = np.random.default_rng(26).random((2, 64, 96, 3), dtype=np.float32)
    ref = jg._featurenet(_params(0)[1]["feat_ext"], jnp.asarray(x))
    with torch.inference_mode():
        got = _net(0).feat_ext(_nchw(x))
    for g, r in zip(got, ref):
        _close(g.permute(0, 2, 3, 1), r, "featurenet")


@pytest.mark.parametrize("union", [False, True])
def test_l_gridnet(union):
    shapes = ((2, 32, 48, 9 if union else 12), (2, 32, 48, 128), (2, 16, 24, 256), (2, 8, 12, 384))
    xs = [_rand(s, 27 + i, 0.5) for i, s in enumerate(shapes)]
    key = "residual_model_head0" if union else "residual_model_head"
    ref = jg._gridnet(_params(0, union)[1]["fusionnet"], *(jnp.asarray(x) for x in xs), key)
    with torch.inference_mode():
        got = _net(0, union).fusionnet(*(_nchw(x) for x in xs))
    assert tuple(got.shape) == (2, 3, 64, 96)
    _close(got.permute(0, 2, 3, 1), ref, "gridnet")


# ---- m: the model -----------------------------------------------------------------


def test_reuse_matches_jax_entry_by_entry():
    ref = _jax_reuse_run(0, HW)
    f0, f1 = (torch.from_numpy(_pad64(f)) for f in _frames(0, HW))
    with torch.inference_mode():
        got = pg.reuse(_net(0), f0, f1)
    assert len(got) == len(ref) == 6
    for name, g, r in zip(("flow01", "flow10"), got[:2], ref[:2]):
        assert tuple(g.shape) == r.shape == (1, 64, 96, 2)
        _assert_parity(g.numpy(), r, name)
    for name, g, r in zip(("metric0", "metric1"), got[2:4], ref[2:4]):
        # metrics read warps and consistency thresholds of the flows: judged as the flows
        _assert_parity(g.numpy(), r, name)
    for g_list, r_list in zip(got[4:], ref[4:]):
        for g, r in zip(g_list, r_list):
            _close(g.numpy(), r, "features")


def test_reuse_at_scale_half_matches_jax():
    """``scale`` = 0.5: GMFlow on the half-resolution pair downscaled again,
    its flows upscaled back (frames padded to multiples of 128)."""
    rng = np.random.default_rng(30)
    f0, f1 = (rng.random((1, 128, 256, 3), dtype=np.float32) for _ in range(2))
    jp = {k: _params(0)[1][k] for k in _REUSE_NETS}
    ref = jax.jit(jg.reuse, static_argnames="scale")(jp, jnp.asarray(f0), jnp.asarray(f1), scale=0.5)
    with torch.inference_mode():
        got = pg.reuse(_net(0), torch.from_numpy(f0), torch.from_numpy(f1), scale=0.5)
    for name, g, r in zip(("flow01", "flow10", "metric0", "metric1"), got[:4], ref[:4]):
        assert tuple(g.shape) == np.asarray(r).shape == (1, 64, 128, 1 if name.startswith("metric") else 2)
        _assert_parity(g.numpy(), np.asarray(r), f"{name} at scale 0.5")


@pytest.mark.parametrize("union", [False, True])
def test_inference_given_jax_reuse_matches_jax(union):
    ref = _jax_apply(0, HW, union)
    f0, f1 = (torch.from_numpy(_pad64(f)) for f in _frames(0, HW))
    cache = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), _jax_reuse_run(0, HW))
    with torch.inference_mode():
        got = pg.inference(_net(0, union), f0, f1, cache, torch.tensor([0.5])).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)


@pytest.mark.parametrize("hw", [HW, GOLDEN_HW])
@pytest.mark.parametrize("union", [False, True])
def test_apply_matches_jax_fp32(union, hw):
    seed = GOLDEN_SEED if hw == GOLDEN_HW else 0
    ref = _jax_apply(seed, hw, union)
    got = _port_apply(seed, hw, union)
    assert got.shape == ref.shape == (1, *hw, 3)
    _assert_parity(got, ref, f"apply union={union} {hw}")


@pytest.mark.parametrize("union", [False, True])
def test_apply_bf16_vs_jax_fp32(union):
    ref = _jax_apply(0, HW, union)
    p = psnr(_port_apply(0, HW, union, torch.bfloat16), ref)
    print(f"GMFSS union={union} bf16 vs JAX fp32: {p:.2f} dB")
    assert p >= 40.0


def test_launch_counts_are_derived_from_the_route():
    assert pg.warps_per_reuse(torch.float32) == pg.warps_per_reuse(torch.bfloat16) == {"narrow": 4, "wide": 2}
    assert pg.warps_per_infer(False) == {"narrow": 0, "wide": 0}
    assert pg.warps_per_infer(True, torch.bfloat16) == {"narrow": 4, "wide": 0}
    assert pg.splats_per_infer() == 8


def test_make_pair_fns_equals_apply_and_crops():
    sd, _ = _params(0)
    f0, f1 = (torch.from_numpy(f[:, :100, :150]) for f in _frames(0, HW))
    reuse_fn, infer_fn = pg.make_pair_fns(sd, device="cpu")
    got = infer_fn(f0, f1, reuse_fn(f0, f1), torch.tensor([0.5]))
    ref = pg.make_model_fn(sd, device="cpu")(f0, f1, torch.tensor([0.5]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (1, 100, 150, 3)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def make_golden(seed=GOLDEN_SEED):
    """JAX GMFSS fp32 output, base and union, at t = 0.5 on the demo pair."""
    return {f"output_{v}": _jax_apply(seed, GOLDEN_HW, v == "union") for v in ("base", "union")}


def test_golden_fixture_is_current_and_port_matches_it():
    with np.load(GOLDEN) as z:
        seed, t, frames = int(z["seed"]), float(z["t"]), z["frames"]
        stored = {k: z[k] for k in ("output_base", "output_union")}
    assert seed == GOLDEN_SEED and t == 0.5
    np.testing.assert_array_equal(frames, demo_frames())
    for key, ref in make_golden(seed).items():
        assert stored[key].shape == (1, *GOLDEN_HW, 3)
        np.testing.assert_allclose(ref, stored[key], atol=1e-6, rtol=0)
        p = psnr(_port_apply(seed, GOLDEN_HW, key.endswith("union")), stored[key])
        print(f"GMFSS golden {key}: port vs JAX {p:.2f} dB")
        assert p >= 40.0


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(
        GOLDEN, seed=np.int64(GOLDEN_SEED), t=np.float32(0.5), frames=demo_frames(), **make_golden(GOLDEN_SEED)
    )
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
