"""The ``space`` axis of the port's ``parallel/`` (rows split over devices,
``parallel/space.py``) against the JAX package's GSPMD row split and
against the port's own one-device runs, on logical replicas of the CPU.

* RIFE 4.7 through ``make_sharded_model_fn`` on a ``(4, 2)`` mesh at b4 x
  128x128 f32, ``t = [0.25, 0.5, 0.5, 0.75]`` (each data shard one frame
  pair, two bands of 64 rows): against JAX's ``jit`` with the frames
  sharded over its ``(4, 2)`` virtual mesh (``frame_sharding``), the
  configuration of ``tests/test_parallel.py:98-132``, within its 1e-4
  (measured 5.5e-6); and against the port's one-device run within 1e-5
  (measured 5.8e-6: each data shard's convolutions run a batch of 1 and a
  band of rows, by other algorithms than the whole batch's).
* ``run_plan`` through ``make_sharded_model_fn`` at 3 frames x 128x128
  against one device (``tests/test_parallel.py:185-209``'s configuration).
* an uneven split: 1 x 136 x 64 splits 128 + 8 rows, and RIFE's pad to 192
  rows lands in the last band (8 + 56 = 64 rows); the ensemble (both
  directions at every stage), at b2 x 128x64.
* the twins' ``row0``: ``warp_torch`` on a band equals the full warp's rows
  bit for bit (border and zeros, an odd height, ``row0`` at the last row);
  ``warp_backward_torch``'s bands sum to the full-height image gradient and
  give the full flow gradient's rows.
* each rule (``conv2d`` at stride 1 and 2 and with dilation 2,
  ``conv_transpose2d(4, 2, 1)``, bilinear resizes down and up, ``F.pad``,
  a crop of the rows, ``pixel_shuffle``; and M2M's: the replicate pad and a
  replicate-padded convolution, the 2x2 stride-2 convolution,
  ``avg_pool2d``, ``prelu``, the cost volume, ``exp``/``abs``/``square``/
  ``sqrt``/comparisons/``clamp(min=)``, means over the rows, columns and
  channels, the frame's mean and ``var``, a sum over the batch and rows,
  the attention's ``einsum``, ``repeat``, ``reshape``, ``unflatten``,
  ``_repeat_branches``, an index with ``...``, the splat; and XVFI's and
  RIFE 4.0's: ``relu`` (``F.relu``, ``nn.ReLU``), ``floor``, ``stack``
  along a new last and first dimension, an index with ``None``, nearest
  ``interpolate`` up by 2 and 3 (``scale_factor=``, ``nn.Upsample``,
  ``size=``) and down by 2, the warp of a plain source by banded flow,
  ``amax``/``amin`` over everything, the rows or the channels; and IFRNet's,
  AMT's and IFUnet's: ``__setitem__`` of a channel slice by bands and by a
  plain tensor, ``torch.cat`` along the rows (and the mean of one), a plain
  map that spans the rows in ``cat`` and in elementwise ops (the timestep
  map, AMT's coordinate grid), ``var_mean`` over the rows and columns and
  over the channels, ``common.instance_norm``, ``view`` and ``expand`` of
  the dimensions before the rows, ``batch_norm`` on stored statistics,
  ``tanh``, ``softmax`` over the channels, ``ifunet.convex_upsample`` at
  levels 4 and 8, and AMT's correlation lookup on bands against
  ``BidirCorr`` on the whole maps; and CAIN's and Sepconv's:
  ``pixel_unshuffle(8)`` after a pad that starts a band off a multiple of
  8, a reflect pad of 60 and 61 rows, ``cain._reflect_pad1``, ``std_mean``
  of stacked frames, ``ones_like`` and ``where``, ``sepconv_func``; and
  FLAVR's and STMFNet's: ``conv3d`` at the stem's ``(3, 7, 7)`` stride
  ``(1, 2, 2)``, the 3x3x3 blocks and the strided block with its 1x1x1
  downsample, on clips whose rows are dimension 3, ``conv_transpose3d``
  ``(3, 4, 4)/(1, 2, 2)/1``, grouped convolutions and transposed
  convolutions at STMFNet's kernel sizes and its ``(2, 2, 0)`` skip, a
  clip's mean, ``reshape`` of the dimensions after the rows, bilinear
  resizes with ``align_corners=True`` up by 2, by 4 from a band off a
  multiple, and down, ``stmfnet._upsampler_8tap``, ``correlation_func``
  and ``adacof_func`` with offsets of up to 40 rows) on 2 and 3 bands
  against the same op on the whole tensor (the reductions over the rows
  give a plain tensor); ``adacof_func``'s bands from their ``row0`` bit
  for bit the whole result's rows; bf16 means, sums and ``var_mean`` over
  the rows bit for bit the whole tensor's (f32 partials, one rounding); the
  ops without a rule raise, naming themselves and the ``ROADMAP.md`` item
  (``softmax`` over the rows, ``batch_norm`` with ``training=True``, a
  ``__setitem__`` that cuts the rows and a ``reshape`` that merges them
  among them); ``band_rows``' splits.
  M2M's pair functions on the axis: ``tests/test_torch_space_m2m.py``;
  IFRNet, AMT and IFUnet: ``tests/test_torch_space_{ifrnet,amt,ifunet}.py``;
  XVFI X4K, CAIN and Sepconv: ``tests/test_torch_space_{x4k,cain,sepconv}.py``;
  FLAVR and STMFNet: ``tests/test_torch_space_{flavr,stmfnet}.py``.
* the re-banding rule, each case equal to the whole tensor bit for bit
  (``torch.equal``): 2 and 3 bands re-banded to other edges (the rows
  moved counted); two values in other bands meeting in an elementwise op,
  a channel ``cat``, ``stack``, ``where`` and a write (the second onto the
  first's edges, where ``_check_alike`` raised before);
  ``pixel_unshuffle(8)`` off a multiple of 8 (132 -> 128, the lower at a
  tie); ``avg_pool2d``, nearest and bilinear downscales by 4 from a band at
  127 (-> 128); a reflect pad of 61-199 rows taken by a band of 8, and
  ``common.reflect_pad``'s periodic pads past the side against numpy; the
  refusal where two output rows cannot give three bands a row each, and of
  edges that empty a band.
* RIFE's other archs on a ``(1, 2)`` mesh at 2 x 192x128 (bands of 128 + 64
  rows) in f64 against the port's one device, within 1e-12 of the output's
  largest value: 4.0, 4.2, 4.3 with and without fast mode, 4.5, 4.6, 4.10,
  4.17 and 4.26; and 4.0 with its restart (``_needs_rescue``) taken and not
  taken (block 1's last convolution scaled by 100 or as drawn), the same
  branch on both runs. Arch 4.0's flag reduces the flow update's largest
  magnitude over the rows (the ``amax`` rule).
* ``dryrun(2, device="cpu")`` trains on ``mesh={'data': 1, 'space': 2}``.
* ``utils/space_witness.py`` at b2 x 136x64 (the pad in the last band): the
  ``(1, 2)`` step's gradients in f64 within 1e-12 of each tensor's largest
  from the ``(1, 1)`` step's (measured 1.7e-15), in f32 within 5e-5.

One JAX compile (the sharded forward at 128x128).
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from comfyui_frame_interpolation_tpu import parallel as jparallel
from comfyui_frame_interpolation_tpu.models import rife as jrife
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict
from comfyui_frame_interpolation_tpu_torch import parallel
from comfyui_frame_interpolation_tpu_torch.core.loop import run_plan, run_plan_window4
from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_timestep, plan_window4
from comfyui_frame_interpolation_tpu_torch.models import cain, common, ifunet, m2m, rife, stmfnet
from comfyui_frame_interpolation_tpu_torch.models.common import cast_params
from comfyui_frame_interpolation_tpu_torch.ops import adacof
from comfyui_frame_interpolation_tpu_torch.ops.adacof import adacof_func
from comfyui_frame_interpolation_tpu_torch.ops.bidir_corr import BidirCorr
from comfyui_frame_interpolation_tpu_torch.ops.correlation import correlation_func
from comfyui_frame_interpolation_tpu_torch.ops.costvol import costvol_func
from comfyui_frame_interpolation_tpu_torch.ops.sepconv import sepconv_func
from comfyui_frame_interpolation_tpu_torch.ops.softsplat import softsplat_func
from comfyui_frame_interpolation_tpu_torch.ops.warp import warp, warp_backward_torch, warp_torch
from comfyui_frame_interpolation_tpu_torch.parallel import space, train
from comfyui_frame_interpolation_tpu_torch.utils import space_witness
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

CPU = torch.device("cpu")
JAX_ATOL = 1e-4  # tests/test_parallel.py:132
ONE_DEVICE_ATOL = 1e-5


def _replicas(n):
    return [CPU] * n


@functools.lru_cache(maxsize=None)
def _params():
    return rife.init_params(1, "4.7")


def _make(device, **kw):
    return rife.make_model_fn(_params(), "4.7", device=device, **kw)


def _frames(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.random(shape, np.float32), rng.random(shape, np.float32)


T4 = np.asarray([0.25, 0.5, 0.5, 0.75], np.float32)


@functools.lru_cache(maxsize=None)
def _port_4x2():
    f0, f1 = _frames((4, 128, 128, 3), 1)
    mesh = parallel.make_mesh(8, devices=_replicas(8))
    assert dict(mesh.shape) == {"data": 4, "space": 2}
    fn = parallel.make_sharded_model_fn(_make, mesh)
    return fn(torch.from_numpy(f0), torch.from_numpy(f1), torch.from_numpy(T4))


def test_rife_on_a_4x2_mesh_matches_jax_sharded():
    f0, f1 = _frames((4, 128, 128, 3), 1)
    jmesh = jparallel.make_mesh(8)
    params = jax.tree_util.tree_map(jnp.asarray, nest_state_dict(_params()))
    scale_list = jrife.default_scale_list("4.7")

    def fwd(params, f0, f1, t):
        return jrife.apply(params, f0, f1, t, scale_list, arch_ver="4.7")

    batch = jparallel.frame_sharding(jmesh, f0.shape)
    assert batch.spec == P("data", "space", None, None)
    sharded = jax.jit(
        fwd,
        in_shardings=(jparallel.replicated(jmesh), batch, batch, NamedSharding(jmesh, P("data"))),
        out_shardings=jparallel.replicated(jmesh),
    )
    with jmesh:
        ref = np.clip(np.asarray(sharded(params, f0, f1, T4)), 0.0, 1.0)
    out = _port_4x2()
    assert out.shape == (4, 128, 128, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=JAX_ATOL)


def test_rife_on_a_4x2_mesh_matches_one_device():
    f0, f1 = _frames((4, 128, 128, 3), 1)
    ref = _make(CPU)(torch.from_numpy(f0), torch.from_numpy(f1), torch.from_numpy(T4))
    torch.testing.assert_close(_port_4x2(), ref, rtol=0, atol=ONE_DEVICE_ATOL)


def test_sharded_model_fn_through_run_plan_matches_one_device():
    frames = torch.from_numpy(np.random.default_rng(3).random((3, 128, 128, 3), np.float32))
    plan = plan_timestep(3, 2)
    ref = run_plan(frames, plan, _make(CPU), batch_size=4)
    mesh = parallel.make_mesh(8, devices=_replicas(8))
    out = run_plan(frames, plan, parallel.make_sharded_model_fn(_make, mesh), batch_size=4)
    assert out.shape == ref.shape == (5, 128, 128, 3)
    torch.testing.assert_close(out, ref, rtol=0, atol=ONE_DEVICE_ATOL)


def test_uneven_split_pads_the_last_band(monkeypatch):
    assert space.band_rows(136, 2) == [(0, 128), (128, 8)]
    padded = []
    pad_rule = space._RULES[F.pad]

    def spy(func, args, kwargs):
        out = pad_rule(func, args, kwargs)
        padded.append([b.shape[out.axis] for b in out.bands])
        return out

    monkeypatch.setitem(space._RULES, F.pad, spy)
    f0, f1 = (torch.from_numpy(a) for a in _frames((1, 136, 64, 3), 5))
    t = torch.full((1,), 0.5)
    ref = _make(CPU)(f0, f1, t)
    out = parallel.make_sharded_model_fn(_make, parallel.make_mesh(2, devices=_replicas(2)))(f0, f1, t)
    assert padded == [[128, 64], [128, 64]]  # both frames: 136 rows padded to 192, the pad in band 2
    assert out.shape == (1, 136, 64, 3)
    torch.testing.assert_close(out, ref, rtol=0, atol=ONE_DEVICE_ATOL)


def test_ensemble_on_a_space_split():
    f0, f1 = (torch.from_numpy(a) for a in _frames((2, 128, 64, 3), 6))
    t = torch.tensor([0.3, 0.6])
    make = functools.partial(_make, ensemble=True)
    ref = make(CPU)(f0, f1, t)
    out = parallel.make_sharded_model_fn(make, parallel.make_mesh(2, devices=_replicas(2)))(f0, f1, t)
    torch.testing.assert_close(out, ref, rtol=0, atol=ONE_DEVICE_ATOL)


# ---- the twins' row band ---------------------------------------------------------


@pytest.mark.parametrize("mode", ["border", "zeros"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_warp_torch_band_equals_the_full_warps_rows(mode, dtype):
    rng = np.random.default_rng(7)
    h = 37
    img = torch.from_numpy(rng.random((2, h, 29, 5), np.float32)).to(dtype)
    flow = torch.from_numpy((rng.random((2, h, 29, 2), np.float32) * 2 - 1) * 9)
    full = warp_torch(img, flow, mode)
    for row0, rows in ((0, 18), (18, 19), (h - 1, 1), (0, h)):
        band = warp_torch(img, flow[:, row0:row0 + rows], mode, row0=row0)
        assert torch.equal(band, full[:, row0:row0 + rows]), (row0, rows)


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_warp_backward_torch_bands_sum_to_the_full_gradient(mode):
    rng = np.random.default_rng(8)
    h = 37
    img = torch.from_numpy(rng.random((2, h, 29, 7), np.float32))
    flow = torch.from_numpy((rng.random((2, h, 29, 2), np.float32) * 2 - 1) * 9)
    grad = torch.from_numpy(rng.random((2, h, 29, 7), np.float32) * 2 - 1)
    gi_full, gf_full = warp_backward_torch(img, flow, grad, mode)
    gi_sum = torch.zeros_like(gi_full)
    for row0, rows in ((0, 20), (20, 16), (h - 1, 1)):
        gi, gf = warp_backward_torch(img, flow[:, row0:row0 + rows], grad[:, row0:row0 + rows], mode, row0=row0)
        assert gi.shape == img.shape and gf.shape == (2, rows, 29, 2)
        torch.testing.assert_close(gf, gf_full[:, row0:row0 + rows], rtol=0, atol=1e-6)
        gi_sum += gi
    torch.testing.assert_close(gi_sum, gi_full, rtol=0, atol=1e-5)


# ---- the rules, one op at a time ---------------------------------------------------


def _nchw(c, h, w, seed):
    x = torch.from_numpy(np.random.default_rng(seed).random((2, c, h, w), np.float32) * 2 - 1)
    return x.contiguous(memory_format=torch.channels_last)


def _weight(o, i, k, seed):
    return torch.from_numpy(np.random.default_rng(seed).random((o, i, k, k), np.float32) - 0.5)


def _bands(x, n):
    return space.split_rows(x, _replicas(n), dim=2)


RULES = {
    "conv2d stride 1": lambda x: F.conv2d(x, _weight(6, 4, 3, 1), torch.ones(6), 1, 1),
    "conv2d stride 2": lambda x: F.conv2d(x, _weight(6, 4, 3, 2), None, 2, 1),
    "conv2d dilation 2": lambda x: F.conv2d(x, _weight(5, 4, 3, 3), None, 1, 2, 2),
    "conv_transpose2d": lambda x: F.conv_transpose2d(x, _weight(4, 3, 4, 4), torch.ones(3), 2, 1),
    "resize down": lambda x: F.interpolate(x, size=(x.shape[2] // 4, 10), mode="bilinear", align_corners=False),
    "resize up": lambda x: F.interpolate(x, size=(x.shape[2] * 4, 80), mode="bilinear", align_corners=False),
    "pad": lambda x: F.pad(x, (0, 3, 2, 5)),
    "crop": lambda x: x[:, 1:3, 5:-7, 2:],
    "pixel_shuffle": lambda x: F.pixel_shuffle(x, 2),
    # M2M's (pair_reuse, pair_infer and their modules)
    "pad replicate": lambda x: F.pad(x, (0, 3, 2, 5), mode="replicate"),
    "conv2d after a replicate pad": lambda x: nn.Conv2d(4, 5, 3, 1, 1, padding_mode="replicate")(x),  # seeded by the test
    "conv2d 2x2 stride 2": lambda x: F.conv2d(x, _weight(6, 4, 2, 4), None, 2, 0),
    "avg_pool2d": lambda x: F.avg_pool2d(x, 2, 2),
    "prelu": lambda x: F.prelu(x, torch.tensor([0.25, -0.5, 0.1, 2.0])),
    "costvol": lambda x: costvol_func(x[:, :2], x[:, 2:]),
    "unary and comparisons": lambda x: torch.exp(x.clamp(-2.0, 2.0)) + x.abs().square().sqrt() * (x < 0.1).to(x.dtype)
    - (x >= 0.3).float() + (0.5 > x).float(),
    "clamp(min=) and rsub": lambda x: (1.0 - 2.0 * x).clamp(min=0.001).square(),
    "mean over the rows and columns": lambda x: x.mean((2, 3), keepdim=True),
    "mean over the rows": lambda x: x.mean(2, keepdim=True),
    "mean over the columns": lambda x: x.mean(3, keepdim=True),
    "mean over the channels": lambda x: x.mean(1, keepdim=True),
    "mean and var of the frame": lambda x: x.var((1, 2, 3), keepdim=True, unbiased=False) + x.mean((1, 2, 3), keepdim=True),
    "sum over the batch and rows": lambda x: x.sum((0, 2)),
    "einsum": lambda x: torch.einsum("nic,nih,niw->nchw", CUBE_C, x.mean(3), CUBE_W),
    "repeat": lambda x: x.repeat(1, 3, 1, 1),
    "reshape": lambda x: x.reshape(4, 2, x.shape[2], x.shape[3]),
    "unflatten and a batch sum": lambda x: x.unflatten(1, (2, 2)).sum(2) + x.unflatten(0, (1, 2)).sum(0)[:, :2],
    "repeat_branches": lambda x: m2m._repeat_branches(x),
    "Ellipsis": lambda x: x.permute(0, 2, 3, 1)[..., 1:-1],
    "softsplat": lambda x: softsplat_func(x[:, 1:].permute(0, 2, 3, 1), (x[:, :2] * 9).permute(0, 2, 3, 1)),
    # XVFI's (its pair functions, RefineUNet and the flow nets' nn.Sequential)
    "relu": lambda x: F.relu(x) + torch.relu(-x) + nn.ReLU()(x - 0.5) + x.relu(),
    "floor": lambda x: torch.floor(x * 7) + (x * 3).floor(),
    "stack last": lambda x: torch.stack([x[:, 0], x[:, 1] * 2], -1),
    "stack first": lambda x: torch.stack([x, x.square()]).sum(0),
    "None after the rows": lambda x: x.permute(0, 2, 3, 1)[..., 0][..., None] * x.permute(0, 2, 3, 1),
    "None before the rows": lambda x: x[:, None, 1] + x[:, 2][:, None] + x[None][0, :, 3:],
    "nearest x2": lambda x: F.interpolate(x, scale_factor=2, mode="nearest"),
    "nearest x3 nn.Upsample": lambda x: nn.Upsample(scale_factor=3, mode="nearest")(x),
    "nearest to a size": lambda x: F.interpolate(x, size=(x.shape[2] * 2, 30), mode="nearest"),
    "nearest down": lambda x: F.interpolate(x, size=(x.shape[2] // 2, 10), mode="nearest"),
    "warp of a plain source": lambda x: warp(
        torch.ones((2, x.shape[2], x.shape[3], 1)), (x[:, :2] * 9).permute(0, 2, 3, 1).float(), "zeros"
    ),
    # RIFE 4.0's restart flag
    "amax of everything": lambda x: (x[:, :2].abs().amax() > 0.9) & (x[:, 2:].abs().amax() > 0.5),
    "amax over the rows": lambda x: torch.amax(x, (2, 3), keepdim=True) - x.amin(2, keepdim=True).amin(3, keepdim=True),
    "amax over the channels": lambda x: x.amax(1, keepdim=True) + torch.amin(x, dim=1)[:, None],
    # IFRNet's, AMT's and IFUnet's
    "setitem of a channel slice": lambda x: _written(x),
    "cat along the rows": lambda x: torch.cat([x, x.square(), x[:, :, :72]], 2),
    "mean of a cat along the rows": lambda x: torch.cat([x, 2.0 * x], 2).float().mean((1, 2, 3), keepdim=True),
    "a spanning plain map in cat": lambda x: torch.cat([x, _row_map(x).expand(2, 1, *x.shape[2:]), x[:, :1]], 1),
    "a spanning plain map in add": lambda x: (_row_map(x) + x - 0.5 * _row_map(x)) * _row_map(x)
    + (_coord(x) + x.permute(0, 2, 3, 1)[..., :2]).permute(0, 3, 1, 2).sum(1, keepdim=True),
    "var_mean over the rows and columns": lambda x: torch.cat(torch.var_mean(x, dim=(2, 3), correction=0, keepdim=True), 1),
    "var_mean over the channels": lambda x: torch.var_mean(x, 1, keepdim=True)[0] * torch.var_mean(x, dim=1)[1][:, None],
    "instance_norm": lambda x: common.instance_norm(x),
    "view": lambda x: x.view(1, 2, 4, *x.shape[2:]).mean(1) + x.view(2, 2, 2, *x.shape[2:])[:, 1].repeat(1, 2, 1, 1),
    "expand": lambda x: x[:, None].expand(2, 3, *x.shape[1:]).reshape(6, *x.shape[1:])
    * x[:1, None].expand(2, 3, 4, -1, -1).reshape(6, 4, *x.shape[2:]),
    "batch_norm eval": lambda x: F.batch_norm(x, BN[0], BN[1], BN[2], BN[3], training=False, eps=1e-3)
    + nn.BatchNorm2d(4).eval()(x),
    "tanh": lambda x: torch.tanh(x) + x.tanh(),
    "softmax over the channels": lambda x: x.softmax(1) + torch.softmax(x * 2, dim=1),
    "convex_upsample x4": lambda x: ifunet.convex_upsample(x * 3, F.conv2d(x, _weight(9 * 16, 4, 1, 5)), 4),
    "convex_upsample x8": lambda x: ifunet.convex_upsample(x * 3, F.conv2d(x, _weight(9 * 64, 4, 1, 6)), 8),
    "bidir_corr lookup": lambda x: _corr_lookup(x),
    # CAIN's and Sepconv's
    "pixel_unshuffle": lambda x: F.pixel_unshuffle(F.pad(x, (2, 2, 4, 4)), 8),
    "reflect pad": lambda x: F.pad(x, (2, 3, 60, 61), mode="reflect"),
    "reflect_pad1": lambda x: cain._reflect_pad1(x),
    "std_mean of the stacked frames": lambda x: torch.cat(torch.std_mean(torch.stack([x, x.square()], 1), dim=(1, 2, 3, 4), correction=1)),
    "ones_like and where": lambda x: torch.where(x.abs() < 0.3, torch.ones_like(x), x),
    "sepconv_func": lambda x: _sepconv(x),
    # FLAVR's and STMFNet's (the window-4 models: clips with the rows on
    # dimension 3, resizes with align_corners=True, three hand-overs)
    "conv3d stem": lambda x: F.conv3d(_clip(x), _weight3(6, 4, (3, 7, 7), 21), None, (1, 2, 2), (1, 3, 3)),
    "conv3d block": lambda x: F.conv3d(_clip(x), _weight3(5, 4, (3, 3, 3), 22), torch.ones(5), 1, 1),
    "conv3d strided block and downsample": lambda x: F.conv3d(_clip(x), _weight3(5, 4, (3, 3, 3), 23), None, (1, 2, 2), 1)
    + F.conv3d(_clip(x), _weight3(5, 4, (1, 1, 1), 24), None, (1, 2, 2), 0),
    "grouped conv2d and conv_transpose2d": lambda x: F.conv_transpose2d(
        F.conv2d(x, _weight(4, 2, 7, 34), None, 2, 3, 1, 2), _weight(4, 2, 6, 35), None, 2, 2, 0, 2
    ) + F.conv_transpose2d(F.conv2d(x, _weight(4, 2, 3, 36), None, 2, 1, 1, 2), _weight(4, 2, 8, 37), None, 2, 3, 0, 2),
    "conv_transpose2d skip (2, 2, 0)": lambda x: F.conv_transpose2d(x, _weight(4, 3, 2, 38), None, 2, 0),
    "conv_transpose3d": lambda x: F.conv_transpose3d(_clip(x), _weight3(4, 3, (3, 4, 4), 25), torch.ones(3), (1, 2, 2), 1),
    "mean of a clip": lambda x: _clip(x) - _clip(x).mean((2, 3, 4), keepdim=True),
    "reshape after the rows": lambda x: _clip(x).permute(0, 3, 4, 2, 1).reshape(2, x.shape[2], x.shape[3], 12)
    .permute(0, 3, 1, 2) + x.reshape(2, 4, x.shape[2], 2, 10).sum(3).repeat(1, 3, 1, 2),
    "bilinear align_corners x2": lambda x: F.interpolate(x, size=(2 * x.shape[2], 30), mode="bilinear", align_corners=True),
    "bilinear align_corners x4 off a multiple": lambda x: F.interpolate(
        F.pad(x, (0, 0, 3, 0)), size=(4 * x.shape[2] + 12, 80), mode="bilinear", align_corners=True
    ),
    "bilinear align_corners down": lambda x: F.interpolate(x, size=(61, 20), mode="bilinear", align_corners=True),
    "upsampler_8tap": lambda x: stmfnet._upsampler_8tap(UPSAMPLER, x),
    "correlation_func": lambda x: correlation_func(x.permute(0, 2, 3, 1), (2.0 * x).square().permute(0, 2, 3, 1)),
    "adacof_func": lambda x: _adacof(x),
}
# a value without rows: the reductions over the rows give a plain tensor
PLAIN_RESULT = {
    "mean over the rows and columns", "mean over the rows", "mean and var of the frame", "sum over the batch and rows",
    "amax of everything", "amax over the rows", "mean of a cat along the rows", "var_mean over the rows and columns",
    "std_mean of the stacked frames",
}
CUBE_C = torch.from_numpy(np.random.default_rng(11).random((2, 4, 3), np.float32))
CUBE_W = torch.from_numpy(np.random.default_rng(12).random((2, 4, 20), np.float32))
# running mean and variance, weight and bias of a 4-channel batch norm
BN = [torch.from_numpy(np.random.default_rng(13 + i).uniform(lo, hi, 4).astype(np.float32))
      for i, (lo, hi) in enumerate([(-0.5, 0.5), (0.5, 1.5), (0.0, 2.0), (-0.5, 0.5)])]


def _written(x):
    """IFRNet's ``ResBlock`` writes: a channel slice by a value in the same
    bands, and one by a plain tensor without rows."""
    y = x * 1.0
    y[:, 2:] = F.conv2d(y[:, 2:], _weight(2, 2, 3, 7), None, 1, 1)
    y[:, :1] = torch.full((2, 1, 1, 1), 0.25)
    return y


def _row_map(x):
    """A plain ``[1, 1, H, 1]`` map built whole from a value's height."""
    return torch.linspace(0.0, 1.0, x.shape[2]).view(1, 1, -1, 1)


def _coord(x):
    """AMT's ``coord``: a plain ``[N, H, W, 2]`` grid of pixel coordinates."""
    gy, gx = torch.meshgrid(torch.arange(x.shape[2], dtype=torch.float32), torch.arange(x.shape[3], dtype=torch.float32), indexing="ij")
    return torch.stack([gx, gy], -1).expand(x.shape[0], *gy.shape, 2)


def _corr_lookup(x):
    """``BidirCorr`` of two 2-channel maps looked up at the coordinate grid
    moved by flows of up to +-6 pixels, both directions."""
    corr = BidirCorr(x[:, :2], x[:, 2:])
    flow = x.permute(0, 2, 3, 1) * 6.0
    c0, c1 = corr.lookup(_coord(x) + flow[..., :2], _coord(x) + flow[..., 2:])
    return torch.cat([c0, c1], 1)


def _weight3(o, i, k, seed):
    return torch.from_numpy(np.random.default_rng(seed).random((o, i, *k), np.float32) - 0.5)


def _clip(x):
    """An NCDHW clip of three frames made from ``x`` (``torch.stack`` along
    a new dimension 2 puts the rows on dimension 3)."""
    return torch.stack([x, x.square(), -x], 2)


# STMFNet's 8-tap filter, one per channel
UPSAMPLER = torch.from_numpy(np.random.default_rng(26).uniform(-0.5, 0.5, (4, 1, 1, 8)).astype(np.float32))


def _adacof(x):
    """``adacof_func`` of a replicate-padded 3-channel input by softmaxed
    weights and offsets of up to +-40 rows from the value's own channels."""
    padded = F.pad(x[:, :3], (2, 2, 2, 2), mode="replicate").permute(0, 2, 3, 1)
    weight = torch.softmax(F.conv2d(x, _weight(25, 4, 1, 27)), 1).permute(0, 2, 3, 1)
    alpha = (40.0 * F.conv2d(x, _weight(25, 4, 1, 28))).permute(0, 2, 3, 1)
    beta = (4.0 * F.conv2d(x, _weight(25, 4, 1, 29))).permute(0, 2, 3, 1)
    return adacof_func(padded, weight, alpha, beta)


def _sepconv(x):
    """``sepconv_func`` of a replicate-padded 2-channel input by 51-tap
    filters from the value's own channels."""
    pad = F.pad(x[:, :2], (25, 25, 25, 25), mode="replicate").permute(0, 2, 3, 1)
    ver = F.conv2d(x, _weight(51, 4, 1, 14)).permute(0, 2, 3, 1)
    hor = F.conv2d(x, _weight(51, 4, 1, 15)).permute(0, 2, 3, 1)
    return sepconv_func(pad, ver, hor)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("rule", list(RULES))
def test_rule_against_the_whole_tensor(rule, n):
    x = _nchw(4, 192 + 8, 20, 9)  # bands of 128 + 72 or 128 + 64 + 8 rows
    torch.manual_seed(0)
    ref = RULES[rule](x)
    torch.manual_seed(0)
    out = RULES[rule](_bands(x, n))
    if rule in PLAIN_RESULT:
        assert isinstance(out, torch.Tensor) and out.shape == ref.shape
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
        return
    assert isinstance(out, space.RowBands) and tuple(out.shape) == tuple(ref.shape)
    torch.testing.assert_close(out.gather(CPU), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [2, 3])
def test_half_precision_reductions_over_the_rows_round_once(n):
    """bf16 bands sum their partials in f32 and round once, as torch sums a
    bf16 tensor: FLAVR's clip mean and SEGating means, a ``sum`` and a
    ``var_mean`` over the rows equal the whole tensor's, bit for bit."""
    x = (torch.from_numpy(np.random.default_rng(40).random((2, 4, 3, 200, 20), np.float32)) * 2 - 1).bfloat16()
    v = space.split_rows(x, _replicas(n), dim=3)
    for f in (
        lambda t: t.mean((2, 3, 4), keepdim=True),
        lambda t: t.sum((0, 3)),
        lambda t: torch.cat(torch.var_mean(t, dim=(3, 4), correction=0, keepdim=True), 1),
    ):
        ref, out = f(x), f(v)
        assert isinstance(out, torch.Tensor) and out.dtype == torch.bfloat16 and torch.equal(out, ref)


@pytest.mark.parametrize("band_elements", [None, 3000])
def test_adacof_bands_from_row0_equal_the_whole_bit_for_bit(band_elements, monkeypatch):
    """``adacof_func`` with ``row0=0`` and ``out_rows`` the whole height is
    the default call, and bands of output rows from their ``row0`` (each
    built in internal chunks of rows with ``BAND_ELEMENTS`` small) are the
    whole result's rows, bit for bit; a band past the output raises."""
    if band_elements is not None:
        monkeypatch.setattr(adacof, "BAND_ELEMENTS", band_elements)
    x = _nchw(4, 70, 20, 30)
    padded = F.pad(x[:, :3], (2, 2, 2, 2), mode="replicate").permute(0, 2, 3, 1)
    maps = [
        torch.softmax(F.conv2d(x, _weight(25, 4, 1, 31)), 1).permute(0, 2, 3, 1),
        (40.0 * F.conv2d(x, _weight(25, 4, 1, 32))).permute(0, 2, 3, 1),
        (4.0 * F.conv2d(x, _weight(25, 4, 1, 33))).permute(0, 2, 3, 1),
    ]
    whole = adacof_func(padded, *maps)
    assert torch.equal(adacof_func(padded, *maps, 1, row0=0, out_rows=70), whole)
    for row0, rows in ((0, 7), (7, 50), (57, 13), (69, 1)):
        band = adacof_func(padded, *(m[:, row0 : row0 + rows] for m in maps), 1, row0=row0, out_rows=70)
        assert torch.equal(band, whole[:, row0 : row0 + rows])
    with pytest.raises(ValueError, match="does not fit"):
        adacof_func(padded, *(m[:, :10] for m in maps), 1, row0=65, out_rows=70)


# ---- the re-banding rule ------------------------------------------------------------------


def _moved(old, new, height):
    """Rows that band ``j`` takes from others when its span goes from
    ``old`` to ``new``."""
    spans = lambda st: list(zip(st, list(st[1:]) + [height]))  # noqa: E731
    return sum((e - a) - max(0, min(e, oe) - max(a, oa)) for (a, e), (oa, oe) in zip(spans(new), spans(old)))


@pytest.mark.parametrize(
    "n, starts", [(2, (0, 100)), (2, (0, 150)), (2, (0, 199)), (3, (0, 60, 130)), (3, (0, 190, 199)), (3, (0, 1, 2))]
)
def test_reband_equals_the_whole_tensor(n, starts):
    x = _nchw(4, 200, 20, 9)
    v = _bands(x, n)
    space.rebands = space.rows_moved = 0
    r = v.reband(starts)
    assert r.starts == starts and r.height == 200 and [b.device for b in r.bands] == [b.device for b in v.bands]
    assert [b.shape[2] for b in r.bands] == [e - a for a, e in zip(starts, list(starts[1:]) + [200])]
    assert torch.equal(r.gather(CPU), x)
    assert (space.rebands, space.rows_moved) == (1, _moved(v.starts, starts, 200))


def test_values_on_other_edges_are_rebanded_onto_the_first():
    """Where ``_check_alike`` raised: an elementwise op, a channel ``cat``,
    ``stack`` and a write of two values of one height in other bands
    re-band the second onto the first's edges, bit for bit."""
    x, y = _nchw(4, 200, 20, 9), _nchw(4, 200, 20, 10)
    a, b = _bands(x, 2), _bands(y, 2).reband((0, 72))
    space.rebands = space.rows_moved = 0
    outs = [a + b, b * a, torch.cat([a, b], 1), torch.stack([a, b], 0).sum(0), torch.where(a > 0, a, b)]
    assert [o.starts for o in outs] == [(0, 128), (0, 72), (0, 128), (0, 128), (0, 128)]  # the first value's edges
    for o, want in zip(outs, [x + y, y * x, torch.cat([x, y], 1), torch.stack([x, y], 0).sum(0), torch.where(x > 0, x, y)]):
        assert torch.equal(o.gather(CPU), want)
    assert (space.rebands, space.rows_moved) == (5, 5 * 56)  # rows 72-127 move, once per op
    z = a * 1.0
    z[:, 2:] = b[:, :2]
    want = x.clone()
    want[:, 2:] = y[:, :2]
    assert torch.equal(z.gather(CPU), want)


@pytest.mark.parametrize("n", [2, 3])
def test_pixel_unshuffle_off_a_multiple_of_8(n):
    """A pad of 4 rows moves the second band's start off a multiple of 8
    (132 = 8 x 16.5): ``pixel_unshuffle(8)`` re-bands it to the nearest one,
    the lower at a tie (128)."""
    x = F.pad(_nchw(4, 200, 24, 9), (0, 0, 4, 4))
    v = F.pad(_bands(_nchw(4, 200, 24, 9), n), (0, 0, 4, 4))
    assert v.starts[1] == 132
    space.rebands = space.rows_moved = 0
    out = F.pixel_unshuffle(v, 8)
    assert out.starts[:2] == (0, 16) and space.rebands == 1 and space.rows_moved == 4 * (n - 1)  # 196 -> 192 too
    assert torch.equal(out.gather(CPU), F.pixel_unshuffle(x, 8))


@pytest.mark.parametrize("op", ["avg_pool2d", "nearest down", "bilinear down"])
def test_downscales_reband_to_their_stride(op):
    fn = {
        "avg_pool2d": lambda t: F.avg_pool2d(t, 4, 4),
        "nearest down": lambda t: F.interpolate(t, size=(t.shape[2] // 4, 5), mode="nearest"),
        "bilinear down": lambda t: F.interpolate(t, size=(t.shape[2] // 4, 5), mode="bilinear", align_corners=False),
    }[op]
    x = _nchw(4, 208, 20, 9)
    v = _bands(x, 2).reband((0, 127))
    space.rebands = 0
    out = fn(v)
    assert out.starts == (0, 32) and space.rebands == 1  # 127 -> 128, the nearest multiple of 4
    assert torch.equal(out.gather(CPU), fn(x))


@pytest.mark.parametrize("pad", [(2, 3, 60, 61), (0, 0, 150, 199), (1, 1, 7, 190)])
def test_reflect_pad_longer_than_its_band(pad):
    """The last of 3 bands holds 8 rows and takes pads of 61-199 rows, read
    from its neighbours; ``common.reflect_pad``'s pads past the side (numpy's
    periodic reflection, in steps) equal numpy's."""
    x = _nchw(4, 200, 20, 9)
    v = _bands(x, 3)
    assert [b.shape[2] for b in v.bands] == [128, 64, 8]
    l, r, t, b = pad
    if max(t, b) < 200:
        assert torch.equal(F.pad(v, pad, mode="reflect").gather(CPU), F.pad(x, pad, mode="reflect"))
    want = np.pad(x.numpy(), ((0, 0), (0, 0), (t + 250, b + 250), (l, r)), mode="reflect")
    assert np.array_equal(common.reflect_pad(v, (l, r, t + 250, b + 250)).gather(CPU).numpy(), want)


def test_an_edge_that_would_empty_a_band_raises():
    """Two output rows cannot give three bands a row each: the op raises,
    naming itself and the ``ROADMAP.md`` item; so does a re-band to edges
    that leave a band without rows."""
    x = _nchw(4, 16, 8, 9)
    v = space.RowBands([x[:, :, :8], x[:, :, 8:12], x[:, :, 12:]], [0, 8, 12], 16, 2)
    with pytest.raises(NotImplementedError, match=r"pixel_unshuffle\(8\).*ROADMAP.md Queue 1 item"):
        F.pixel_unshuffle(v, 8)
    with pytest.raises(NotImplementedError, match="a band would empty.*ROADMAP.md Queue 1 item"):
        _bands(_nchw(4, 200, 8, 9), 2).reband((0, 200))


def _cut_rows(x):
    x[:, :, 1:] = 0.0


NO_RULE = {
    "softmax over the rows": lambda x: x.softmax(2),
    "Tensor.view": lambda x: x.view(-1),
    "Tensor.reshape": lambda x: x.permute(0, 2, 3, 1).reshape(2, -1, 4),  # merges the rows with the columns
    "interpolate": lambda x: F.interpolate(x, scale_factor=2, mode="bicubic"),
    "batch_norm with training=True": lambda x: F.batch_norm(x, torch.zeros(4), torch.ones(4), training=True),
    "avg_pool2d": lambda x: F.avg_pool2d(x, 3, 1),
    "Tensor.__setitem__ of an index that cuts the rows": _cut_rows,
}


@pytest.mark.parametrize("name", list(NO_RULE))
def test_an_op_without_a_rule_raises_naming_itself(name):
    with pytest.raises(NotImplementedError, match=f"{name}.*ROADMAP.md Queue 1 item"):
        NO_RULE[name](_bands(_nchw(4, 128, 16, 0), 2))


def test_a_window4_model_on_a_space_split_raises():
    frames = torch.rand(6, 128, 64, 3)

    def make(device):
        return lambda f0, f1, f2, f3: torch.stack([f0, f1, f2, f3]).median(0).values

    sharded = parallel.make_sharded_model_fn(make, parallel.make_mesh(2, devices=_replicas(2)))
    with pytest.raises(NotImplementedError, match="median.*ROADMAP.md Queue 1 item"):
        run_plan_window4(frames, plan_window4(6), sharded, batch_size=2)


@pytest.mark.parametrize(
    "height, n, spans",
    [
        (1080, 2, [(0, 576), (576, 504)]),
        (1088, 2, [(0, 576), (576, 512)]),
        (224, 2, [(0, 128), (128, 96)]),
        (128, 2, [(0, 64), (64, 64)]),
        (200, 3, [(0, 128), (128, 64), (192, 8)]),
    ],
)
def test_band_rows(height, n, spans):
    assert space.band_rows(height, n) == spans


# ---- RIFE's other archs -------------------------------------------------------------

RIFE_ARCHS = [
    ("4.0", True), ("4.0", False), ("4.2", True), ("4.2", False), ("4.3", True), ("4.3", False),
    ("4.5", True), ("4.6", True), ("4.10", True), ("4.17", True), ("4.26", True),
]
ARCH_RTOL = 1e-12


def _f64_model_fn(arch, fastmode, block1_scale, device):
    """``rife.apply`` in f64 with f64 out: ``make_model_fn``'s f32 result
    would round two f64 results a few ulps apart to f32 values one f32 ulp
    apart now and then."""
    params = dict(rife.init_params(0, arch))
    if block1_scale != 1.0:
        for k in ("block1.lastconv.weight", "block1.lastconv.bias"):
            params[k] = params[k] * block1_scale
    with torch.device("meta"):
        net = rife.IFNet(arch)
    net.load_state_dict(cast_params(params, torch.float64), strict=True, assign=True)
    net = net.to(device=device, memory_format=torch.channels_last).eval()

    @torch.inference_mode()
    def model_fn(f0, f1, t):
        f0, f1 = (f.to(device=device, dtype=torch.float64) for f in (f0, f1))
        return rife.apply(net, f0, f1, t.to(device=device, dtype=torch.float64), rife.default_scale_list(arch), fastmode=fastmode)

    return model_fn


def _arch_runs(arch, fastmode, block1_scale=1.0):
    """The f64 one-device and ``(1, 2)`` outputs at 2 x 192x128."""
    f0, f1 = (torch.from_numpy(a) for a in _frames((2, 192, 128, 3), 13))
    t = torch.tensor([0.3, 0.6])
    make = functools.partial(_f64_model_fn, arch, fastmode, block1_scale)

    mesh = parallel.make_mesh(2, devices=_replicas(2))
    assert parallel.frame_sharding(mesh, f0.shape).spec == ("data", "space", None, None)
    return make(CPU)(f0, f1, t), parallel.make_sharded_model_fn(make, mesh)(f0, f1, t)


@pytest.mark.parametrize("arch, fastmode", RIFE_ARCHS, ids=[f"{a}{'' if f else ' refined'}" for a, f in RIFE_ARCHS])
def test_rife_arch_on_a_space_split_matches_one_device_in_f64(arch, fastmode):
    ref, out = _arch_runs(arch, fastmode)
    assert out.shape == ref.shape == (2, 192, 128, 3)
    gap = (out - ref).abs().max().item()
    assert gap <= ARCH_RTOL * ref.abs().max().item(), gap


@pytest.mark.parametrize("block1_scale, rescued", [(1.0, False), (100.0, True)])
def test_rife40_restart_on_a_space_split(block1_scale, rescued, monkeypatch):
    """The restart flag reduces over the split's rows (the ``amax`` rule)
    and takes the one device's branch: block 1's last convolution scaled by
    100 pushes the flow update past 32 px both ways."""
    flags = []
    needs_rescue = rife._needs_rescue
    monkeypatch.setattr(rife, "_needs_rescue", lambda fd: flags.append(needs_rescue(fd)) or flags[-1])
    ref, out = _arch_runs("4.0", True, block1_scale)
    assert flags == [rescued, rescued]  # one device, then the (1, 2) mesh
    assert (out - ref).abs().max().item() <= ARCH_RTOL * ref.abs().max().item()


def test_dryrun_trains_on_the_space_axis(capsys):
    train.dryrun(2, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip(2) OK: loss=" in out and "mesh={'data': 1, 'space': 2}" in out


def test_space_witness_f64_split_is_exact():
    out = space_witness.main(["--batch", "2", "--hw", "136", "64", "--no-card"])
    assert out["split_gap"]["cpu f64"]["max"] <= 1e-12
    assert out["split_gap"]["cpu f32"]["max"] <= 5e-5
    assert out["losses"]["cpu f64 (1, 2)"] == pytest.approx(out["losses"]["cpu f64 (1, 1)"], rel=1e-12)
