"""The port's layer primitives against the JAX package's ``models/common.py``
(fp32, atol 1e-5). JAX takes NHWC arrays and parameter dicts; the port takes
NCHW tensors and weights in torch layout, so the tests permute."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.models import common as jc
from comfyui_frame_interpolation_tpu_torch.models import common as pc
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def _close(got_nchw, ref_nhwc, atol=ATOL):
    np.testing.assert_allclose(got_nchw.permute(0, 2, 3, 1).numpy(), np.asarray(ref_nhwc), atol=atol, rtol=0)


@pytest.mark.parametrize("stride,padding,dilation", [(1, 1, 1), (2, 1, 1), (1, 2, 2), (2, 0, 1), (1, (1, 2), (1, 2))])
def test_conv2d(stride, padding, dilation):
    rng = _rng(1)
    x = rng.standard_normal((2, 17, 23, 5)).astype(np.float32)
    w = (rng.standard_normal((6, 5, 3, 3)) * 0.2).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    ref = jc.conv2d(jnp.asarray(x), {"weight": w, "bias": b}, stride=stride, padding=padding, dilation=dilation)
    got = pc.conv2d(_nchw(x), torch.from_numpy(w), torch.from_numpy(b), stride, padding, dilation)
    _close(got, ref)


@pytest.mark.parametrize("stride,padding,k", [(2, 1, 4), (2, 0, 3), (1, 1, 3)])
def test_conv_transpose2d(stride, padding, k):
    rng = _rng(2)
    x = rng.standard_normal((2, 9, 11, 6)).astype(np.float32)
    w = (rng.standard_normal((6, 4, k, k)) * 0.2).astype(np.float32)  # IOHW
    b = rng.standard_normal(4).astype(np.float32)
    ref = jc.conv_transpose2d(jnp.asarray(x), {"weight": w, "bias": b}, stride=stride, padding=padding)
    got = pc.conv_transpose2d(_nchw(x), torch.from_numpy(w), torch.from_numpy(b), stride, padding)
    _close(got, ref)


def test_pixel_shuffle_and_activations():
    rng = _rng(3)
    x = rng.standard_normal((2, 5, 7, 12)).astype(np.float32)
    _close(pc.pixel_shuffle(_nchw(x), 2), jc.pixel_shuffle(jnp.asarray(x), 2), atol=0)
    _close(pc.leaky_relu(_nchw(x), 0.2), jc.leaky_relu(jnp.asarray(x), 0.2))
    _close(pc.sigmoid(_nchw(x)), jc.sigmoid(jnp.asarray(x)))
    a = rng.random(12).astype(np.float32)
    _close(pc.prelu(_nchw(x), torch.from_numpy(a)), jc.prelu(jnp.asarray(x), {"weight": a}))


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize(
    "in_hw,out_hw",
    [((32, 48), (4, 6)), ((32, 48), (16, 24)), ((8, 12), (64, 96)), ((8, 12), (16, 24)),
     ((30, 50), (17, 23)), ((17, 23), (40, 31)), ((32, 48), (32, 12))],
)
def test_resize_bilinear(in_hw, out_hw, align_corners):
    x = _rng(4).random((2, *in_hw, 3), dtype=np.float32)
    ref = jc.resize_bilinear(jnp.asarray(x), out_hw, align_corners)
    _close(pc.resize_bilinear(_nchw(x), out_hw, align_corners), ref)


@pytest.mark.parametrize("scale", [0.125, 0.25, 0.5, 2.0, 4.0, 8.0])
def test_resize_by_scale(scale):
    x = _rng(5).random((1, 64, 128, 4), dtype=np.float32)
    if scale > 1:
        x = x[:, :8, :16]
    ref = jc.resize_by_scale(jnp.asarray(x), scale)
    _close(pc.resize_by_scale(_nchw(x), scale), ref)


@pytest.mark.parametrize("in_hw,scale", [((8, 12), 2.0), ((20, 32), 2.0), ((68, 120), 2.0), ((16, 24), 0.5)])
def test_resize_by_scale_align_corners(in_hw, scale):
    """GMFlow's flow upsampling between its scales (``align_corners=True``).
    JAX takes the tap weights from float64 source coordinates, torch from
    float32 ones: the weights differ by up to ~1e-5 at 120 columns, so the
    tolerance is 2e-5 of the values' magnitude."""
    x = _rng(11).standard_normal((2, *in_hw, 2)).astype(np.float32) * 5
    ref = jc.resize_by_scale(jnp.asarray(x), scale, align_corners=True)
    _close(pc.resize_by_scale(_nchw(x), scale, align_corners=True), ref, atol=2e-5 * (1 + float(np.abs(x).max())))


@pytest.mark.parametrize("bias", [True, False])
def test_linear(bias):
    rng = _rng(12)
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    node = {"weight": rng.standard_normal((5, 16)).astype(np.float32)}
    if bias:
        node["bias"] = rng.standard_normal(5).astype(np.float32)
    ref = jc.linear(jnp.asarray(x), node)
    got = pc.linear(torch.from_numpy(x), *(torch.from_numpy(node[k]) for k in ("weight", "bias") if k in node))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_prelu_single_slope():
    """GMFSS's ``nn.PReLU(1)``: one slope for every channel."""
    x = _rng(13).standard_normal((2, 5, 7, 6)).astype(np.float32)
    a = np.asarray([0.25], np.float32)
    _close(pc.prelu(_nchw(x), torch.from_numpy(a)), jc.prelu(jnp.asarray(x), {"weight": a}), atol=0)
    torch.testing.assert_close(pc.prelu(_nchw(x), torch.from_numpy(a)), torch.nn.functional.prelu(_nchw(x), torch.from_numpy(a)))


def test_cast_params():
    sd = {"w": torch.ones(2, dtype=torch.float32), "n": torch.arange(3)}
    out = pc.cast_params(sd, torch.bfloat16)
    assert out["w"].dtype == torch.bfloat16 and out["n"].dtype == torch.int64


@pytest.mark.parametrize("hw,k,stride", [((16, 24), 2, 2), ((17, 23), 2, 2), ((15, 20), 3, 2), ((12, 12), 3, None)])
def test_avg_pool2d(hw, k, stride):
    x = _rng(6).standard_normal((2, *hw, 5)).astype(np.float32)
    ref = jc.avg_pool2d(jnp.asarray(x), k, stride)
    _close(pc.avg_pool2d(_nchw(x), k, stride), ref)


@pytest.mark.parametrize("hw,k,stride", [((16, 24), 2, 2), ((17, 23), 3, 2), ((15, 20), 3, 1), ((12, 12), 3, None)])
def test_max_pool2d(hw, k, stride):
    x = _rng(14).standard_normal((2, *hw, 5)).astype(np.float32)
    ref = jc.max_pool2d(jnp.asarray(x), k, stride)
    _close(pc.max_pool2d(_nchw(x), k, stride), ref, atol=0)


@pytest.mark.parametrize("affine", [True, False])
def test_batch_norm(affine):
    """Eval mode: the running statistics, eps 1e-5."""
    rng = _rng(15)
    x = rng.standard_normal((2, 9, 11, 6)).astype(np.float32)
    node = {"running_mean": rng.standard_normal(6).astype(np.float32), "running_var": rng.uniform(0.2, 3.0, 6).astype(np.float32)}
    if affine:
        node.update(weight=rng.standard_normal(6).astype(np.float32), bias=rng.standard_normal(6).astype(np.float32))
    ref = jc.batch_norm(jnp.asarray(x), node)
    t = {k: torch.from_numpy(v) for k, v in node.items()}
    got = pc.batch_norm(_nchw(x), t["running_mean"], t["running_var"], t.get("weight"), t.get("bias"))
    _close(got, ref)


@pytest.mark.parametrize("in_hw,out_hw", [((135, 240), (67, 120)), ((67, 120), (135, 240)), ((8, 12), (16, 24)), ((17, 23), (40, 31)), ((30, 50), (17, 23))])
def test_resize_nearest(in_hw, out_hw):
    x = _rng(7).random((2, *in_hw, 3), dtype=np.float32)
    ref = jc.resize_nearest(jnp.asarray(x), out_hw)
    _close(pc.resize_nearest(_nchw(x), out_hw), ref, atol=0)


@pytest.mark.parametrize("k", [2, 3])
def test_conv2d_same_padding(k):
    """torch ``padding="same"`` is JAX ``"same_torch"``: for k = 2 the extra
    pad goes right and bottom."""
    rng = _rng(8)
    x = rng.standard_normal((2, 9, 14, 5)).astype(np.float32)
    w = (rng.standard_normal((4, 5, k, k)) * 0.3).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    ref = jc.conv2d(jnp.asarray(x), {"weight": w, "bias": b}, padding="same_torch")
    got = pc.conv2d(_nchw(x), torch.from_numpy(w), torch.from_numpy(b), padding="same")
    assert tuple(got.shape) == (2, 4, 9, 14)
    _close(got, ref)


@pytest.mark.parametrize("padding", [1, "same"])
def test_conv2d_concat(padding):
    rng = _rng(9)
    parts = [rng.standard_normal((2, 11, 13, c)).astype(np.float32) for c in (3, 6, 2)]
    w = (rng.standard_normal((5, 11, 3, 3)) * 0.2).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    jpad = "same_torch" if padding == "same" else padding
    ref = jc.conv2d_concat([jnp.asarray(p) for p in parts], {"weight": w, "bias": b}, padding=jpad)
    got = pc.conv2d_concat([_nchw(p) for p in parts], torch.from_numpy(w), torch.from_numpy(b), padding=padding)
    _close(got, ref)
    with pytest.raises(ValueError):
        pc.conv2d_concat([_nchw(p) for p in parts[:2]], torch.from_numpy(w))


@pytest.mark.parametrize("parts", [(7,), (3, 4)])
def test_conv2x2_up2x(parts):
    """vs JAX, and vs the plain pair it fuses: nearest 2x, then a 2x2
    ``padding="same"`` convolution; on one tensor and on channel parts."""
    rng = _rng(10)
    xs = [rng.standard_normal((2, 6, 9, c)).astype(np.float32) for c in parts]
    w = (rng.standard_normal((4, sum(parts), 2, 2)) * 0.3).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    node = {"weight": w, "bias": b}
    jx = [jnp.asarray(x) for x in xs]
    tx = [_nchw(x) for x in xs]
    ref = jc.conv2x2_up2x(jx if len(xs) > 1 else jx[0], node)
    got = pc.conv2x2_up2x(tx if len(xs) > 1 else tx[0], torch.from_numpy(w), torch.from_numpy(b))
    assert tuple(got.shape) == (2, 4, 12, 18) and got.is_contiguous(memory_format=torch.channels_last)
    _close(got, ref)
    plain = pc.conv2d(pc.resize_nearest(torch.cat(tx, 1), (12, 18)), torch.from_numpy(w), torch.from_numpy(b), padding="same")
    torch.testing.assert_close(got, plain, atol=ATOL, rtol=0)


@pytest.mark.parametrize("groups,stride,k", [(32, 2, 7), (32, 1, 3), (3, 1, 5)])
def test_conv2d_groups(groups, stride, k):
    """Grouped convolutions (STMFNet's ResNeXt blocks, groups 32, and its
    gaussian blur, groups 3): OIHW weight ``(O, I/groups, kh, kw)``."""
    rng = _rng(16)
    c = 2 * groups if groups > 3 else 3
    x = rng.standard_normal((2, 13, 18, c)).astype(np.float32)
    w = (rng.standard_normal((c, c // groups, k, k)) * 0.3).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    ref = jc.conv2d(jnp.asarray(x), {"weight": w, "bias": b}, stride=stride, padding=(k - 1) // 2, groups=groups)
    got = pc.conv2d(_nchw(x), torch.from_numpy(w), torch.from_numpy(b), stride, (k - 1) // 2, groups=groups)
    _close(got, ref)


@pytest.mark.parametrize("k", [4, 6, 8])
def test_conv_transpose2d_groups(k):
    """Grouped transposed convolutions (STMFNet's up blocks, groups 32, pad
    ``(k - 2) // 2``): IOHW weight ``(I, O/groups, kh, kw)``."""
    rng = _rng(17)
    x = rng.standard_normal((2, 5, 7, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 2, k, k)) * 0.2).astype(np.float32)
    ref = jc.conv_transpose2d(jnp.asarray(x), {"weight": w}, stride=2, padding=(k - 2) // 2, groups=32)
    got = pc.conv_transpose2d(_nchw(x), torch.from_numpy(w), None, 2, (k - 2) // 2, groups=32)
    assert tuple(got.shape) == (2, 64, 10, 14)
    _close(got, ref)


def test_batch_norm_takes_5d_clips():
    """``batch_norm`` on an NCDHW clip is ``BatchNorm3d`` (STMFNet's UNet3d),
    against JAX on the NDHWC clip."""
    rng = _rng(18)
    x = rng.standard_normal((2, 5, 9, 11, 6)).astype(np.float32)
    node = {k: rng.standard_normal(6).astype(np.float32) for k in ("running_mean", "weight", "bias")}
    node["running_var"] = rng.uniform(0.2, 3.0, 6).astype(np.float32)
    ref = np.asarray(jc.batch_norm(jnp.asarray(x), node))
    t = {k: torch.from_numpy(v) for k, v in node.items()}
    clip = torch.from_numpy(x).permute(0, 4, 1, 2, 3)  # NCDHW view of channels_last_3d memory
    got = pc.batch_norm(clip, t["running_mean"], t["running_var"], t["weight"], t["bias"])
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), ref, atol=ATOL, rtol=0)


def test_channels_last_params():
    m = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.Conv3d(4, 5, 3), torch.nn.Linear(5, 6))
    pc.channels_last_params(m)
    assert m[0].weight.is_contiguous(memory_format=torch.channels_last)
    assert m[1].weight.is_contiguous(memory_format=torch.channels_last_3d)
    assert m[2].weight.is_contiguous()


@pytest.mark.parametrize("in_hw,scale", [((17, 30), 2.0), ((8, 12), 4.0), ((20, 32), 0.5), ((17, 23), 0.25)])
def test_resize_by_scale_nearest(in_hw, scale):
    """IFUnet's RRDBNet upsampling (``mode="nearest"``), exact."""
    x = _rng(19).random((2, *in_hw, 3), dtype=np.float32)
    ref = jc.resize_by_scale(jnp.asarray(x), scale, mode="nearest")
    _close(pc.resize_by_scale(_nchw(x), scale, mode="nearest"), ref, atol=0)
    with pytest.raises(ValueError, match="unsupported resize mode"):
        pc.resize_by_scale(_nchw(x), scale, mode="bicubic")


@pytest.mark.parametrize("hw", [(9, 13), (1, 7)])
def test_instance_norm(hw):
    """AMT's and GMFSS's ``InstanceNorm2d`` without affine (JAX
    ``amt._inorm``): population variance, eps 1e-5, on values with a large
    mean; within 1e-5 of the normalised values' magnitude."""
    from comfyui_frame_interpolation_tpu.models import amt as jamt

    x = (_rng(20).standard_normal((2, *hw, 5)) * 3 + 7).astype(np.float32)
    ref = np.asarray(jamt._inorm(jnp.asarray(x)))
    got = pc.instance_norm(_nchw(x).contiguous(memory_format=torch.channels_last))
    _close(got, ref, atol=1e-5 * (1 + float(np.abs(ref).max())))


def test_init_state_dict_is_seeded_and_starts_norms_at_identity():
    m = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4), torch.nn.PReLU(4), torch.nn.Linear(4, 2))
    a, b, c = pc.init_state_dict(m, 0), pc.init_state_dict(m, 0), pc.init_state_dict(m, 1)
    assert a.keys() == m.state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["0.weight"], c["0.weight"])
    assert torch.equal(a["1.running_var"], torch.ones(4)) and torch.equal(a["1.bias"], torch.zeros(4))
    assert a["1.num_batches_tracked"].dtype == torch.int64
    assert torch.equal(a["2.weight"], torch.full((4,), pc.PRELU_INIT))
    bound = 1 / np.sqrt(27)
    assert 0.9 * bound < float(a["0.weight"].abs().max()) <= bound
    assert float(a["3.bias"].abs().max()) <= 0.5
