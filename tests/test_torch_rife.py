"""The port's RIFE against the JAX package's, on the CPU, with the same weights
carried across by ``params_from_jax``.

* ``apply`` for every arch (4.0, 4.6, 4.7 and 4.10 with the ensemble off and
  on) at full width on ``[2, 64, 128, 3]`` frames with ``t = [0.5, 0.25]``:
  fp32 max-abs <= 1e-4 (convolution sums are taken in another order than
  XLA:CPU's); 4.0-4.3 also with ``fastmode=False`` (Contextnet and Unet).
* arch 4.0's rescue in both branches and on a mixed batch (only one sample's
  stage-1 flow update exceeds 32 pixels, so the batch-wide flag restarts
  both samples): max-abs <= 2e-4 (flows of up to 80 pixels).
* ``warps_per_forward`` equals the warps a forward makes, as routed.
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
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

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


@functools.lru_cache(maxsize=None)
def _jax_fn(arch, ensemble, fastmode):
    """JAX ``apply`` jitted once per configuration (the weights are an
    argument, so one compile serves every weight set of a shape)."""
    return jax.jit(
        functools.partial(
            jrife.apply, scale_list=jrife.default_scale_list(arch), arch_ver=arch, ensemble=ensemble,
            fastmode=fastmode,
        )
    )


def _jax_apply(params, f0, f1, t, arch, ensemble=False, fastmode=True):
    fn = _jax_fn(arch, ensemble, fastmode)
    return np.asarray(fn(params, jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(t)))


def _port_net(sd, arch):
    with torch.device("meta"):
        net = prife.IFNet(arch)
    net.load_state_dict(sd, strict=True, assign=True)
    return net.to(memory_format=torch.channels_last)


def _port_apply(sd, f0, f1, t, arch, ensemble=False, fastmode=True):
    net = _port_net(sd, arch)
    with torch.inference_mode():
        out = prife.apply(
            net, torch.from_numpy(f0), torch.from_numpy(f1), torch.as_tensor(t),
            prife.default_scale_list(arch), ensemble=ensemble, fastmode=fastmode,
        )
    return out.numpy()


def test_arch_versions_equal_jax():
    assert prife.ARCH_VERSIONS == jrife.ARCH_VERSIONS
    assert prife.CKPT_NAME_VER_DICT == jrife.CKPT_NAME_VER_DICT


@pytest.mark.parametrize(
    "arch,ensemble",
    [
        ("4.6", False), ("4.6", True), ("4.7", False), ("4.7", True), ("4.17", False), ("4.26", False),
        ("4.0", False), ("4.0", True), ("4.2", False), ("4.3", False), ("4.5", False), ("4.10", False),
        ("4.10", True),
    ],
)
def test_apply_matches_jax_fp32(arch, ensemble):
    f0, f1 = _frames(0)
    t = np.asarray([0.5, 0.25], np.float32)
    jp = _jax_params(arch)
    ref = _jax_apply(jp, f0, f1, t, arch, ensemble)
    got = _port_apply(params_from_jax(jp), f0, f1, t, arch, ensemble)
    assert got.shape == ref.shape == (2, 64, 128, 3)
    assert np.abs(got - ref).max() <= 1e-4


@pytest.mark.parametrize("arch,ensemble", [("4.0", False), ("4.0", True), ("4.2", False), ("4.3", False)])
def test_refine_matches_jax_fp32(arch, ensemble):
    """``fastmode=False``: the Contextnet features of both frames, warped at
    four levels, and the Unet on the pre-sigmoid mask."""
    f0, f1 = _frames(2)
    t = np.asarray([0.5, 0.25], np.float32)
    jp = _jax_params(arch)
    ref = _jax_apply(jp, f0, f1, t, arch, ensemble, fastmode=False)
    got = _port_apply(params_from_jax(jp), f0, f1, t, arch, ensemble, fastmode=False)
    assert np.abs(got - ref).max() <= 1e-4
    assert np.abs(got - _port_apply(params_from_jax(jp), f0, f1, t, arch, ensemble)).max() > 1e-3


def _stage1_updates(sd, f0, f1, t):
    """Per sample, the largest stage-1 flow update of 4.0 in each direction
    (x0/y0 and x1/y1): what the rescue flag reduces over the batch."""
    net = _port_net(sd, "4.0")
    scales = prife.default_scale_list("4.0")
    with torch.inference_mode():
        img0, img1 = (torch.from_numpy(f).permute(0, 3, 1, 2) for f in (f0, f1))
        tmap = torch.from_numpy(t).reshape(-1, 1, 1, 1).expand(-1, 1, *img0.shape[2:])
        blocks = net.blocks()
        flow, mask, _ = prife._if_block(blocks[0], [img0, img1, tmap], None, scales[0])
        w0, w1 = prife._warp_both(img0, img1, flow)
        fd, _, _ = prife._if_block(blocks[1], [w0, w1, tmap, mask], flow, scales[1])
    return fd[:, :2].abs().amax((1, 2, 3)).numpy(), fd[:, 2:4].abs().amax((1, 2, 3)).numpy()


@pytest.mark.parametrize("branch", ["normal", "rescued", "mixed"])
def test_rescue_matches_jax_fp32(branch):
    """Arch 4.0's restart with doubled scales. Block 1's head is scaled by
    ``k`` (its flow update scales with it): ``normal`` keeps both samples
    under 32 pixels, ``rescued`` puts both over, ``mixed`` only the first,
    where the flag over the whole batch restarts both, as JAX's ``lax.cond``
    does. The Contextnet/Unet refinement runs on the result. Tolerance 2e-4:
    the flow updates reach 16-80 pixels here, and the coordinates' f32
    rounding grows with them (8.2e-5 measured in the rescued branch)."""
    f0, f1 = _frames(3)
    f0[1], f1[1] = 0.0, 0.0  # a black second sample: its update is about half the first's
    t = np.asarray([0.5, 0.25], np.float32)
    sd = prife.init_params(0, "4.0")
    a, b = _stage1_updates(sd, f0, f1, t)
    batch_at, loud_at, quiet_at = 32 / min(a.max(), b.max()), 32 / min(a[0], b[0]), 32 / min(a[1], b[1])
    assert loud_at < quiet_at  # the first sample exceeds 32 at a smaller k
    k = {"normal": 0.5 * batch_at, "rescued": 1.2 * quiet_at, "mixed": (loud_at * quiet_at) ** 0.5}[branch]
    if branch == "mixed":  # the first sample alone would restart, the second alone would not
        assert batch_at <= loud_at < k < quiet_at
    sd = dict(sd)
    for key in ("block1.lastconv.weight", "block1.lastconv.bias"):
        sd[key] = sd[key] * k
    a, b = _stage1_updates(sd, f0, f1, t)
    assert prife._needs_rescue(torch.from_numpy(np.stack([a, a, b, b], 1)[..., None, None])) == (branch != "normal")
    jp = to_jax_tree(nest_state_dict(sd))
    ref = _jax_apply(jp, f0, f1, t, "4.0", fastmode=False)
    got = _port_apply(sd, f0, f1, t, "4.0", fastmode=False)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 2e-4


@pytest.mark.parametrize(
    "arch,fastmode,ensemble",
    [("4.0", True, False), ("4.0", False, True), ("4.3", False, False), ("4.6", True, True), ("4.7", True, False),
     ("4.7", True, True), ("4.10", True, False), ("4.17", True, True), ("4.26", True, False)],
)
def test_warps_per_forward_counts_the_routed_warps(monkeypatch, arch, fastmode, ensemble):
    """Each warp of a forward on the CPU, routed by its planes' shape, strides
    and dtype as the card would route it, against ``warps_per_forward``."""
    from comfyui_frame_interpolation_tpu_torch.ops.cuda import warp_kernel

    routed = {"narrow": 0, "wide": 0}
    real = prife.warp

    def spy(img, flow, *args, **kwargs):
        planes = img.permute(0, 3, 1, 2)
        body = warp_kernel.route(planes.shape, planes.stride(), planes.dtype)
        routed["wide" if body == "wide" else "narrow"] += 1
        return real(img, flow, *args, **kwargs)

    monkeypatch.setattr(prife, "warp", spy)
    f0, f1 = _frames(4, (1, 64, 64, 3))
    _port_apply(prife.init_params(0, arch), f0, f1, np.asarray([0.5], np.float32), arch, ensemble, fastmode)
    assert routed == prife.warps_per_forward(arch, fastmode, ensemble)
    if not fastmode:
        assert routed["wide"] == 4  # the Contextnet's levels, both frames per call


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


def test_rife40_layout():
    """4.0: the 4.6 block widths with PReLU activations, 8 plain convs, a bare
    5-channel head; Contextnet (C = 16 to 128) and Unet (17 input channels)."""
    with torch.device("meta"):
        sd = prife.IFNet("4.0").state_dict()
    assert {k.split(".")[0] for k in sd} == {"block0", "block1", "block2", "block3", "contextnet", "unet"}
    for i, (cin, c) in enumerate(((7, 192), (12, 128), (12, 96), (12, 64))):
        assert tuple(sd[f"block{i}.conv0.0.0.weight"].shape) == (c // 2, cin, 3, 3)
        assert tuple(sd[f"block{i}.conv0.0.1.weight"].shape) == (c // 2,)
        assert tuple(sd[f"block{i}.convblock.7.1.weight"].shape) == (c,)
        assert tuple(sd[f"block{i}.lastconv.weight"].shape) == (c, 5, 4, 4)
    assert tuple(sd["contextnet.conv4.conv2.0.weight"].shape) == (128, 128, 3, 3)
    assert tuple(sd["unet.down0.conv1.0.weight"].shape) == (32, 17, 3, 3)
    assert tuple(sd["unet.up0.0.weight"].shape) == (512, 128, 4, 4)
    assert tuple(sd["unet.conv.weight"].shape) == (3, 16, 3, 3)
    params = prife.init_params(0, "4.0")
    assert torch.equal(params["unet.up3.1.weight"], torch.full((16,), prife.PRELU_INIT))
    with torch.device("meta"):
        assert not any(k.endswith(".1.weight") and v.dim() == 1 for k, v in prife.IFNet("4.2").state_dict().items())


@pytest.mark.parametrize("arch", ["4.1", "4.4", "5.0"])
def test_unported_arch_raises(arch):
    """Every arch of the JAX package is ported: a name outside them raises."""
    with pytest.raises(ValueError, match="unknown RIFE arch"):
        prife.IFNet(arch)
    with pytest.raises(ValueError, match="unknown RIFE arch"):
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
