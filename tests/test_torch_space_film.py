"""FILM on the ``space`` axis of the port's ``parallel/`` (rows split over
devices) through ``make_sharded_model_fn`` and ``run_plan``, against the
JAX package's GSPMD split and against the port's own one-device runs, on
logical replicas of the CPU.

* FILM on a ``(4, 2)`` mesh, 3 frames x 256x128 f32, ``plan_timestep(3,
  3)`` (batch 4: each data shard one item, two bands of 128 rows), against
  JAX's ``apply`` jitted with the frames sharded over its ``(4, 2)``
  virtual mesh by ``frame_sharding`` (what JAX's ``make_sharded_model_fn``
  does; the weights an argument, so the compile does not fold 34 M
  constants), clamped as JAX's ``make_model_fn`` clamps, through JAX's
  ``run_plan``; within ``tests/test_parallel.py``'s 1e-4 (measured 1.8e-7;
  JAX's split is 1.2e-7 from its one device there).
* The split at 128x128 on a ``(2, 2)`` mesh (one pair a data shard,
  ``plan_timestep(3, 2)``, batch 2) against the port's one device, f64
  within 1e-6 and f32 within 3e-5 (measured 0 in both: the clamp to [0, 1]
  takes most of a random-weight FILM's outputs, so ``apply`` is held
  unclamped too).
* ``film.apply`` unclamped on the bands of an uneven split, 2 x 200x64 in
  128 + 72 rows (a pyramid of 200, 100, 50, 25, 12, 6 and 3 rows: the flow
  pyramid resizes 3 -> 6 -> 12 -> 25 -> 50 rows, 12 -> 25 by a ratio that
  is not an integer, and the fusion's 12 -> 25 step takes the nearest
  resize, ``common.resize_nearest``, and a 2x2 ``padding="same"``
  convolution), in f64 within 1e-12 of the output's largest magnitude
  (measured 3.2e-16).
* each rule FILM needed, on 2 and 3 bands against the whole tensor:
  ``conv2d(padding="same")`` at k = 1, 2, 3, 7, an even 2x1 and 1x2 and
  dilation 2; ``common.conv2x2_up2x`` on bands alone and as channel parts
  (bands and plain tensors mixed in ``conv2d_concat`` too); bilinear resizes
  by ratios that are not integers, up and down; ``index_select`` of rows
  (``resize_nearest``) and of columns.

One JAX compile (the sharded forward at 256x128).
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu import parallel as jparallel
from comfyui_frame_interpolation_tpu.core import plan_timestep as jplan_timestep
from comfyui_frame_interpolation_tpu.core import run_plan as jrun_plan
from comfyui_frame_interpolation_tpu.models import film as jfilm
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch import parallel
from comfyui_frame_interpolation_tpu_torch.core.loop import run_plan
from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_timestep
from comfyui_frame_interpolation_tpu_torch.models import common, film
from comfyui_frame_interpolation_tpu_torch.parallel import space
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

CPU = torch.device("cpu")
JAX_ATOL = 1e-4  # tests/test_parallel.py:132
F32_ATOL = 3e-5
F64_ATOL = 1e-6
RULE_ATOL = 1e-5


def _replicas(n):
    return [CPU] * n


@functools.lru_cache(maxsize=None)
def _params():
    return film.init_params(0)


def _make(dtype=torch.float32):
    return lambda d: film.make_model_fn(_params(), dtype=dtype, device=d)


def _frames(h, w, seed=21):
    return np.random.default_rng(seed).random((3, h, w, 3), np.float32)


def _run(frames, make, mesh=None, mids=2, batch_size=4):
    fn = make(CPU) if mesh is None else parallel.make_sharded_model_fn(make, mesh)
    return run_plan(torch.from_numpy(frames), plan_timestep(3, mids + 1), fn, batch_size=batch_size)


def _mesh_4x2():
    mesh = parallel.make_mesh(8, devices=_replicas(8))
    assert dict(mesh.shape) == {"data": 4, "space": 2}
    return mesh


def test_film_on_a_4x2_mesh_matches_jax_sharded():
    frames = _frames(256, 128)
    jmesh = jparallel.make_mesh(8)
    batch = jparallel.frame_sharding(jmesh, (4, 256, 128, 3))
    assert batch.spec == ("data", "space", None, None)
    sharded = jax.jit(
        lambda p, a, b: jnp.clip(jfilm.apply(p, a, b), 0.0, 1.0),
        in_shardings=(jparallel.replicated(jmesh), batch, batch),
        out_shardings=jparallel.replicated(jmesh),
    )
    params = to_jax_tree(nest_state_dict(_params()))

    def jax_fn(f0, f1, t):
        with jmesh:
            return sharded(params, f0, f1)

    ref = np.asarray(jrun_plan(jnp.asarray(frames), jplan_timestep(3, 3), jax_fn, batch_size=4))
    out = _run(frames, _make(), _mesh_4x2())
    assert out.shape == (7, 256, 128, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=JAX_ATOL)


@pytest.mark.parametrize("dtype, atol", [(torch.float64, F64_ATOL), (torch.float32, F32_ATOL)])
def test_film_on_a_2x2_mesh_matches_one_device(dtype, atol):
    frames = _frames(128, 128)
    mesh = parallel.make_mesh(4, devices=_replicas(4))
    assert dict(mesh.shape) == {"data": 2, "space": 2}
    ref = _run(frames, _make(dtype), mids=1, batch_size=2)
    out = _run(frames, _make(dtype), mesh, mids=1, batch_size=2)
    assert out.shape == ref.shape == (5, 128, 128, 3) and out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=0, atol=atol)


def test_film_apply_on_an_uneven_split_matches_one_device_in_f64(monkeypatch):
    assert space.band_rows(200, 2) == [(0, 128), (128, 72)]
    rng = np.random.default_rng(22)
    f0, f1 = (torch.from_numpy(rng.random((2, 200, 64, 3))) for _ in range(2))
    net = film._load(_params(), torch.float64, CPU)
    ran = set()

    def recording(fn):
        return lambda *a: ran.add(fn.__name__) or fn(*a)

    for name in ("_bilinear_rows", "_conv2d_same"):  # called by the interpolate and conv2d rules
        monkeypatch.setattr(space, name, recording(getattr(space, name)))
    for f, rule in list(space._RULES.items()):
        if rule in (space._index_select, space._conv2x2_up2x_rule):
            monkeypatch.setitem(space._RULES, f, recording(rule))
    with torch.inference_mode():
        ref = film.apply(net, f0, f1)
        out = film.apply(net, space.split_rows(f0, _replicas(2)), space.split_rows(f1, _replicas(2)))
    assert isinstance(out, space.RowBands) and out.starts == (0, 128)
    assert ran == {"_bilinear_rows", "_index_select", "_conv2x2_up2x_rule", "_conv2d_same"}
    gap = (out.gather(CPU) - ref).abs().max().item()
    assert gap <= 1e-12 * ref.abs().max().item(), gap


# ---- the rules, one op at a time ---------------------------------------------------


def _nchw(c, h, w, seed):
    x = torch.from_numpy(np.random.default_rng(seed).random((2, c, h, w), np.float32) * 2 - 1)
    return x.contiguous(memory_format=torch.channels_last)


def _weight(o, i, kh, kw, seed):
    return torch.from_numpy(np.random.default_rng(seed).random((o, i, kh, kw), np.float32) - 0.5)


ROWS = torch.from_numpy(np.floor(np.arange(403) * (200 / 403)).astype(np.int64))
RULES = {
    "same k1": lambda x: F.conv2d(x, _weight(5, 4, 1, 1, 1), torch.ones(5), padding="same"),
    "same k2": lambda x: F.conv2d(x, _weight(5, 4, 2, 2, 2), None, padding="same"),
    "same k3": lambda x: F.conv2d(x, _weight(5, 4, 3, 3, 3), torch.ones(5), padding="same"),
    "same k7": lambda x: F.conv2d(x, _weight(5, 4, 7, 7, 4), None, padding="same"),
    "same 2x1 and 1x2": lambda x: F.conv2d(x, _weight(5, 4, 2, 1, 5), None, padding="same")
    + F.conv2d(x, _weight(5, 4, 1, 2, 6), None, padding="same"),
    "same dilation 2": lambda x: F.conv2d(x, _weight(5, 4, 3, 3, 7), None, padding="same", dilation=2),
    "same nn.Conv2d k2": lambda x: torch.nn.Conv2d(4, 3, 2, padding="same")(x),  # seeded by the test
    "conv2x2_up2x": lambda x: common.conv2x2_up2x(x, _weight(3, 4, 2, 2, 8), torch.ones(3)),
    "conv2x2_up2x of parts": lambda x: common.conv2x2_up2x([x[:, :1], x[:, 1:]], _weight(3, 4, 2, 2, 9), torch.ones(3)),
    "conv2d_concat same": lambda x: common.conv2d_concat([x[:, :3], x[:, 3:] * 2], _weight(5, 4, 3, 3, 10), torch.ones(5), padding="same"),
    "bilinear up by 403/200": lambda x: F.interpolate(x, size=(403, 41), mode="bilinear", align_corners=False),
    "bilinear down by 77/200": lambda x: F.interpolate(x, size=(77, 20), mode="bilinear", align_corners=False),
    "resize_nearest": lambda x: common.resize_nearest(x, (403, 41)),
    "index_select of rows": lambda x: x.index_select(2, ROWS) + torch.index_select(x, -2, ROWS.flip(0)),
    "index_select of columns": lambda x: x.index_select(3, torch.tensor([0, 3, 3, 19, 7])),
}


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("rule", list(RULES))
def test_rule_against_the_whole_tensor(rule, n):
    x = _nchw(4, 192 + 8, 20, 19)  # bands of 128 + 72 or 128 + 64 + 8 rows
    torch.manual_seed(0)
    ref = RULES[rule](x)
    torch.manual_seed(0)
    out = RULES[rule](space.split_rows(x, _replicas(n), dim=2))
    assert isinstance(out, space.RowBands) and tuple(out.shape) == tuple(ref.shape)
    torch.testing.assert_close(out.gather(CPU), ref, rtol=0, atol=RULE_ATOL)


def test_conv2x2_up2x_of_a_plain_tensor_is_unchanged():
    """One device keeps the code it ran: a plain tensor or list of plain
    parts takes no hand-over, and the result is the same bits as the phase
    convolutions interleaved by hand."""
    x, w = _nchw(4, 12, 10, 30), _weight(3, 4, 2, 2, 31)
    out = common.conv2x2_up2x(x, w)
    up = F.interpolate(x, scale_factor=2, mode="nearest")
    torch.testing.assert_close(out, F.conv2d(up, w, padding="same"), rtol=0, atol=1e-5)
    assert torch.equal(common.conv2x2_up2x([x[:, :2], x[:, 2:]], w), common.conv2x2_up2x(x[:, :2], w[:, :2]) + common.conv2x2_up2x(x[:, 2:], w[:, 2:]))
