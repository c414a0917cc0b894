"""The port's EISAI against the JAX package's, on the CPU, with the same weights
(the port's numpy ``init_params`` carried across by ``nest_state_dict``) and
the same numpy inputs.

* ``state_dict`` keys and shapes equal the three manifests
  (``tests/fixtures/ckpt_manifests.json``: ``eisai_anime_interp_full.ckpt``'s
  RFR under ``raft.``, ``eisai_ssl.pt`` under ``ssl.``, ``eisai_dtm.pt`` under
  ``dtm.``); seeding is deterministic; batch norms start at the identity.
* ``batch_edt`` is bit-exact (integer squared distances in f32).
* the image utilities (``rgb_to_lab``, ``gaussian_blur``/``batch_dog``,
  ``_morph_open``, ``flow_backwarp``, ``pixel_logit``) within 1e-5 of the
  magnitude (``batch_dog`` within 1e-6); ``nedt`` by the share of pixels
  whose edge-map threshold flips (at most 0.2 %, from convolution sums in
  another order) and the mean difference.
* ``rfr_flow`` (64x96, and 68x100, which RFR resizes to multiples of 8),
  ``raft_flow`` and ``raft_pair`` with 3 iterations, ``_half_warper``, the
  ResNet trunk, ``ssl_forward`` and ``dtm_forward`` each within
  ``TOL`` = 2e-5 x (1 + the largest magnitude), fp32; the frames splatted
  with the Lab metric's weights within ``TOL_SOFT`` = 5e-5 x (1 + magnitude).
* ``make_pair_fns`` end to end (64x96, batch 2, t = [0.5, 0.25], 2
  iterations) against the bodies of JAX ``make_pair_fns`` within ``TOL``;
  bf16 against JAX fp32 >= 40 dB.
* ``warps_per_infer`` and ``splats_per_infer`` equal what one forward makes.
* the JAX golden (``tests/fixtures/torch_port_eisai_golden.npz``: the demo
  frames every fourth pixel, 135x240, t = 0.5, the reference's 12
  iterations, weights from the seed) is regenerated with JAX and must be
  unchanged; the port matches it at >= 40 dB.

Run ``python tests/test_torch_eisai.py`` to rewrite the fixture.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.models import eisai as je
from comfyui_frame_interpolation_tpu.ops.edt import batch_edt as jax_edt
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch.models import eisai as pe
from comfyui_frame_interpolation_tpu_torch.ops.edt import batch_edt
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port_eisai_golden.npz")
DEMO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "demo_frames")
GOLDEN_SEED = 1234
HW = (64, 96)
TOL = 2e-5
# the soft splat's weights exp(-0.1 |Lab difference|) carry the rounding of
# Lab values of magnitude ~100 (4.2e-5 measured on the splatted frames)
TOL_SOFT = 5e-5
_FILES = {"raft": "eisai_anime_interp_full.ckpt", "ssl": "eisai_ssl.pt", "dtm": "eisai_dtm.pt"}


def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(1.0 / mse)


@functools.lru_cache(maxsize=None)
def _params(seed):
    sd = pe.init_params(seed)
    return sd, to_jax_tree(nest_state_dict(sd))


@functools.lru_cache(maxsize=None)
def _net(seed, dtype=torch.float32):
    return pe._load(_params(seed)[0], dtype, "cpu")


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


def _close(got, ref, what, tol=TOL):
    ref = np.asarray(ref)
    got = np.asarray(got)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= tol * (1.0 + np.abs(ref).max()), (what, err)


def _frames(seed, hw=HW, n=2):
    rng = np.random.default_rng(seed)
    return rng.random((n, *hw, 3), dtype=np.float32), rng.random((n, *hw, 3), dtype=np.float32)


def _smooth_flows(seed, hw=HW, n=2, amp=3.0):
    """A pair of smooth (y, x) flows, NHWC."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0 : hw[0], 0 : hw[1]].astype(np.float32)
    out = []
    for _ in range(2):
        f = np.empty((n, *hw, 2), np.float32)
        for i in range(n):
            for c in range(2):
                a, b, p = rng.uniform(0.03, 0.12), rng.uniform(0.03, 0.12), rng.uniform(0, 6.3)
                f[i, ..., c] = amp * np.sin(a * xx + b * yy + p)
        out.append(f)
    return out


# ---- a. layout and weights -------------------------------------------------------


def test_state_dict_equals_the_three_manifests():
    path = os.path.join(os.path.dirname(__file__), "fixtures", "ckpt_manifests.json")
    with open(path) as f:
        manifests = json.load(f)["manifests"]
    want = {f"{pre}.{k}": v for pre, name in _FILES.items() for k, v in manifests[name]["tensors"].items()}
    with torch.device("meta"):
        sd = pe.EISAI().state_dict()
    assert {k: list(v.shape) for k, v in sd.items()} == want
    params = pe.init_params(0)
    assert params.keys() == sd.keys() and len(params) == 513


def test_init_params_is_seeded_and_norms_start_at_identity():
    a, b, c = pe.init_params(0), pe.init_params(0), pe.init_params(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["raft.fnet.conv1.weight"], c["raft.fnet.conv1.weight"])
    assert torch.equal(a["ssl.feature_extractor.bn1.running_var"], torch.ones(64))
    assert torch.equal(a["ssl.feature_extractor.bn1.running_mean"], torch.zeros(64))
    assert a["dtm.net_tail.net.2.num_batches_tracked"].dtype == torch.int64
    assert torch.equal(a["dtm.net_nedt.net.0.weight"], torch.full((14,), pe.PRELU_INIT))
    bound = 1 / np.sqrt(324)
    w = a["raft.update_block.encoder.convc1.weight"]
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound


# ---- b. EDT and image utilities ------------------------------------------------------


@pytest.mark.parametrize("shape,density", [((2, 37, 53), 0.03), ((1, 1, 64, 96), 0.005), ((1, 20, 300), 0.0)])
def test_batch_edt_is_bit_exact(shape, density):
    edges = (np.random.default_rng(7).random(shape) < density).astype(np.float32)
    ref = np.asarray(jax_edt(jnp.asarray(edges)))
    got = batch_edt(torch.from_numpy(edges)).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_rgb_to_lab_and_pixel_logit():
    x = np.random.default_rng(1).random((2, 16, 24, 3), dtype=np.float32)
    x[0, 0, :4, 0] = [0.0, 0.01, 0.04045, 1.0]  # both sides of the sRGB knee
    _close(_nhwc(pe.rgb_to_lab(_nchw(x))), je.rgb_to_lab(jnp.asarray(x)), "lab", 1e-5)
    _close(_nhwc(pe.pixel_logit(_nchw(x))), je.pixel_logit(jnp.asarray(x)), "logit", 1e-5)


@pytest.mark.parametrize("ksize,sigma", [(5, 1.0), (11, 2.6)])
def test_gaussian_blur_and_dog(ksize, sigma):
    x = np.random.default_rng(2).random((2, 30, 41, 3), dtype=np.float32)
    _close(_nhwc(pe.gaussian_blur(_nchw(x), ksize, sigma)), je.gaussian_blur(jnp.asarray(x), ksize, sigma), "blur", 1e-6)
    ref = je.batch_dog(jnp.asarray(x), t=2.0, sigma=sigma, clip=False)
    _close(_nhwc(pe.batch_dog(_nchw(x), t=2.0, sigma=sigma, clip=False)), ref, "dog", 1e-6)


def test_nedt_flips_few_edges():
    x = np.asarray(_demo_frames(4)[0], np.float32) / 255.0  # real edges, 135x240
    ref = np.asarray(je.nedt(jnp.asarray(x)))
    got = _nhwc(pe.nedt(_nchw(x)))
    assert got.shape == ref.shape and np.isfinite(got).all()
    dog_ref = np.asarray(je.batch_dog(jnp.asarray(x), t=2.0, sigma=135 / 540, clip=False)) > 0.5
    dog_got = _nhwc(pe.batch_dog(_nchw(x), t=2.0, sigma=135 / 540, clip=False)) > 0.5
    assert np.mean(dog_ref != dog_got) <= 0.002
    assert np.mean(np.abs(got - ref)) <= 1e-3
    assert np.mean(np.abs(got - ref) > 1e-5) <= 0.02


@pytest.mark.parametrize("k", [0, 3, 5])
def test_morph_open(k):
    x = np.random.default_rng(3).random((2, 19, 27, 1), dtype=np.float32)
    _close(_nhwc(pe._morph_open(_nchw(x), k)), je._morph_open(jnp.asarray(x), k), f"open {k}", 0.0)


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_flow_backwarp(mode):
    img = np.random.default_rng(4).random((2, *HW, 3), dtype=np.float32) * 80
    flow, _ = _smooth_flows(4, amp=5.0)  # (y, x) pixels, some taps off the frame
    ref = je.flow_backwarp(jnp.asarray(img), jnp.asarray(flow), mode)
    got = pe.flow_backwarp(_nchw(img), torch.from_numpy(flow).permute(0, 3, 1, 2), mode)
    _close(_nhwc(got), ref, "backwarp", 1e-5)


# ---- c. RFR ---------------------------------------------------------------------------------


_jax_rfr = jax.jit(je.rfr_flow, static_argnames="iters")
_jax_raft = jax.jit(je.raft_flow, static_argnames="iters")


@pytest.mark.parametrize("hw", [HW, (68, 100)])
def test_rfr_flow(hw):
    f0, f1 = _frames(5, hw)
    ref = _jax_rfr(_params(0)[1]["raft"], jnp.asarray(f0), jnp.asarray(f1), iters=3)
    with torch.inference_mode():
        got = pe.rfr_flow(_net(0).raft, _nchw(f0), _nchw(f1), 3)
    _close(_nhwc(got), ref, "rfr")


def test_raft_flow_and_pair():
    f0, f1 = _frames(6)
    jp = _params(0)[1]["raft"]
    ref0 = _jax_raft(jp, jnp.asarray(f0), jnp.asarray(f1), iters=3)
    ref1 = _jax_raft(jp, jnp.asarray(f1), jnp.asarray(f0), iters=3)
    net = _net(0).raft
    with torch.inference_mode():
        one = pe.raft_flow(net, _nchw(f0), _nchw(f1), 3)
        pair = pe.raft_pair(net, _nchw(f0), _nchw(f1), 3)
    _close(_nhwc(one), ref0, "raft_flow")
    _close(_nhwc(pair[0]), ref0, "raft_pair 0")
    _close(_nhwc(pair[1]), ref1, "raft_pair 1")


# ---- d. SoftsplatLite and DTM -------------------------------------------------------------


@pytest.mark.parametrize("t", [0.5, (0.3, 0.75)])
def test_half_warper(t):
    rng = np.random.default_rng(8)
    img0, img1 = (rng.random((2, *HW, 4), dtype=np.float32) for _ in range(2))
    flow0, flow1 = _smooth_flows(8)
    z0, z1 = (-rng.random((2, *HW, 1), dtype=np.float32) * 3 for _ in range(2))
    tj = jnp.asarray(np.asarray(t, np.float32).reshape(-1, 1, 1, 1))
    ref = je._half_warper(*(jnp.asarray(a) for a in (img0, img1, flow0, flow1, z0, z1)), 5, tj)
    fl = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in (flow0, flow1)]
    got = pe._half_warper(
        _nchw(img0), _nchw(img1), *fl, _nchw(z0), _nchw(z1), 5, torch.tensor(t).float().reshape(-1, 1, 1, 1)
    )
    for g, r, name in zip(got, ref, ("imgs", "flows", "masks")):
        for gi, ri in zip(g, r):
            _close(_nhwc(gi), ri, f"half warper {name}")


def test_resnet_trunk():
    x = np.random.default_rng(9).random((2, *HW, 4), dtype=np.float32)
    ref = jax.jit(je._resnet_features)(_params(0)[1]["ssl"]["feature_extractor"], jnp.asarray(x))
    with torch.inference_mode():
        got = pe._resnet_features(_net(0).ssl.feature_extractor, _nchw(x[..., :3]))
    assert [tuple(g.shape[1:]) for g in got] == [(64, 128, 192), (256, 64, 96), (512, 32, 48)]
    for g, r, lvl in zip(got, ref, ("conv1", "layer1", "layer2")):
        _close(_nhwc(g), r, lvl)


@functools.lru_cache(maxsize=None)
def _jax_ssl_run():
    f0, f1 = _frames(10)
    flow0, flow1 = _smooth_flows(10)
    t = np.asarray([0.5, 0.25], np.float32).reshape(-1, 1, 1, 1)
    fn = jax.jit(je.ssl_forward)
    pred, locs = fn(_params(0)[1]["ssl"], *(jnp.asarray(a) for a in (f0, f1, flow0, flow1, t)))
    return (f0, f1, flow0, flow1, t), jax.tree_util.tree_map(np.asarray, (pred, locs))


def test_ssl_forward():
    (f0, f1, flow0, flow1, t), (pred, locs) = _jax_ssl_run()
    fl = [torch.from_numpy(f).permute(0, 3, 1, 2) for f in (flow0, flow1)]
    with torch.inference_mode():
        got, glocs = pe.ssl_forward(_net(0).ssl, _nchw(f0), _nchw(f1), *fl, torch.from_numpy(t))
    _close(_nhwc(got), pred, "ssl pred")
    for key in ("hw_imgs", "hw_masks"):
        for g, r in zip(glocs[key], locs[key]):
            _close(_nhwc(g), r, key, TOL_SOFT)


def test_dtm_forward():
    _, (pred, locs) = _jax_ssl_run()
    ref = jax.jit(je.dtm_forward)(_params(0)[1]["dtm"], jnp.asarray(pred), locs)
    tl = {k: [_nchw(v) for v in vs] for k, vs in locs.items()}
    with torch.inference_mode():
        got = pe.dtm_forward(_net(0).dtm, _nchw(pred), tl)
    _close(_nhwc(got), ref, "dtm")


# ---- e. the pair functions ------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames="iters")
def _jax_reuse(p, f0, f1, iters):
    """The body of JAX ``make_pair_fns``'s ``reuse_fn``, with the weights as
    an argument (``make_pair_fns`` closes over them, which compiles them in
    as constants: slower, and a large entry in the persistent cache)."""
    return je.raft_flow(p["raft"], f0, f1, iters=iters), je.raft_flow(p["raft"], f1, f0, iters=iters)


@jax.jit
def _jax_infer(p, f0, f1, cache, t):
    """The body of JAX ``make_pair_fns``'s ``infer_fn``, weights as an argument."""
    out_ssl, locs = je.ssl_forward(p["ssl"], f0, f1, cache[0], cache[1], t=t.reshape(-1, 1, 1, 1))
    return je.dtm_forward(p["dtm"], out_ssl, locs)[..., :3]


def _jax_pair(p, f0, f1, t, iters):
    cache = _jax_reuse(p, jnp.asarray(f0), jnp.asarray(f1), iters=iters)
    return cache, _jax_infer(p, jnp.asarray(f0), jnp.asarray(f1), cache, jnp.asarray(t))


@functools.lru_cache(maxsize=None)
def _jax_pair_run(iters=2):
    f0, f1 = _frames(11)
    t = np.asarray([0.5, 0.25], np.float32)
    cache, out = _jax_pair(_params(0)[1], f0, f1, t, iters)
    return (f0, f1, t), [np.asarray(c) for c in cache], np.asarray(out)


def test_make_pair_fns_matches_jax_fp32():
    (f0, f1, t), cache, ref = _jax_pair_run()
    reuse_fn, infer_fn = pe.make_pair_fns(_params(0)[0], device="cpu", iters=2)
    got_cache = reuse_fn(torch.from_numpy(f0), torch.from_numpy(f1))
    for g, r in zip(got_cache, cache):
        _close(g.numpy(), r, "cache")
    got = infer_fn(torch.from_numpy(f0), torch.from_numpy(f1), got_cache, torch.from_numpy(t))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (2, *HW, 3)
    _close(got.numpy(), ref, "make_pair_fns")
    one = pe.make_model_fn(_params(0)[0], device="cpu", iters=2)(torch.from_numpy(f0), torch.from_numpy(f1), torch.from_numpy(t))
    _close(one.numpy(), ref, "make_model_fn")


def test_bf16_vs_jax_fp32():
    (f0, f1, t), _, ref = _jax_pair_run()
    reuse_fn, infer_fn = pe.make_pair_fns(_params(0)[0], dtype=torch.bfloat16, device="cpu", iters=2)
    a, b = torch.from_numpy(f0), torch.from_numpy(f1)
    got = infer_fn(a, b, reuse_fn(a, b), torch.from_numpy(t))
    assert got.dtype == torch.float32
    assert psnr(got.numpy(), ref) >= 40.0


def test_launch_counts_equal_a_forward(monkeypatch):
    """The warps and splats of one infer on the CPU, routed by their planes
    as the card would route them, against ``warps_per_infer`` and
    ``splats_per_infer``; the reuse makes neither."""
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import warp_kernel

    seen = {"narrow": 0, "wide": 0, "splat": []}
    real_warp, real_splat = pe.warp, pe.function_softsplat

    def warp_spy(img, flow, *args):
        planes = img.permute(0, 3, 1, 2)
        seen["wide" if warp_kernel.route(planes.shape, planes.stride(), planes.dtype) == "wide" else "narrow"] += 1
        return real_warp(img, flow, *args)

    def splat_spy(x, flow, metric, mode):
        seen["splat"].append((x.shape[-1] + 1, x.dtype))
        return real_splat(x, flow, metric, mode)

    monkeypatch.setattr(pe, "warp", warp_spy)
    monkeypatch.setattr(pe, "function_softsplat", splat_spy)
    f0, f1 = (torch.from_numpy(f) for f in _frames(12, n=1))
    reuse_fn, infer_fn = pe.make_pair_fns(_params(0)[0], dtype=torch.bfloat16, device="cpu", iters=1)
    cache = reuse_fn(f0, f1)
    assert seen == {"narrow": 0, "wide": 0, "splat": []}
    infer_fn(f0, f1, cache, torch.tensor([0.5]))
    assert {"narrow": seen["narrow"], "wide": seen["wide"]} == pe.warps_per_infer()
    assert len(seen["splat"]) == pe.splats_per_infer()
    assert tuple(c for c, _ in seen["splat"]) == pe.SPLAT_CHANNELS_PER_INFER
    assert all(d == torch.float32 for _, d in seen["splat"])


# ---- f. the golden ----------------------------------------------------------------------------


def _demo_frames(step):
    """``anime0.png`` and ``anime1.png`` every ``step``-th pixel, uint8 ``[2,
    1, H, W, 3]``."""
    from PIL import Image

    imgs = [np.asarray(Image.open(os.path.join(DEMO, f"anime{i}.png")).convert("RGB")) for i in (0, 1)]
    return np.stack(imgs)[:, None, ::step, ::step]


def make_golden(seed=GOLDEN_SEED):
    """JAX EISAI fp32 at t = 0.5 on the demo frames every fourth pixel (the
    reference's 12 iterations), weights ``init_params(seed)``."""
    frames = _demo_frames(4)
    f0, f1 = (frames[i].astype(np.float32) / 255.0 for i in (0, 1))
    _, out = _jax_pair(to_jax_tree(nest_state_dict(pe.init_params(seed))), f0, f1, np.asarray([0.5], np.float32), 12)
    return frames, np.asarray(out)


def test_golden_fixture_is_current_and_port_matches_it():
    with np.load(GOLDEN) as z:
        seed, t, frames, stored = int(z["seed"]), float(z["t"]), z["frames"], z["output"]
    assert seed == GOLDEN_SEED and t == 0.5 and stored.shape == (1, 135, 240, 3)
    np.testing.assert_array_equal(frames, _demo_frames(4))
    np.testing.assert_allclose(make_golden(seed)[1], stored, atol=1e-6, rtol=0)
    f0, f1 = (torch.from_numpy(frames[i].astype(np.float32) / 255.0) for i in (0, 1))
    got = pe.make_model_fn(pe.init_params(seed), device="cpu")(f0, f1, torch.tensor([t]))
    assert psnr(got.numpy(), stored) >= 40.0
    _close(got.numpy(), stored, "golden", 1e-4)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    frames, out = make_golden(GOLDEN_SEED)
    np.savez_compressed(GOLDEN, seed=np.int64(GOLDEN_SEED), t=np.float32(0.5), frames=frames, output=out)
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
