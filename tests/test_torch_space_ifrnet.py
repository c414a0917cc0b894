"""IFRNet on the ``space`` axis of the port's ``parallel/`` (rows split over
devices) through ``make_sharded_model_fn`` and ``run_plan``, against the
JAX package's GSPMD split and against the port's own one-device runs, on
logical replicas of the CPU.

* IFRNet S on a ``(4, 2)`` mesh, 3 frames x 128x128 f32, ``plan_timestep(3,
  3)`` (batch 4: each data shard one pair, two bands of 64 rows), against
  JAX's ``apply`` jitted with the frames sharded over its ``(4, 2)``
  virtual mesh by ``frame_sharding`` (the weights an argument), clamped as
  the port's output is, through JAX's ``run_plan``; within
  ``tests/test_parallel.py``'s 1e-4 (measured 3.6e-6; JAX's split is
  3.7e-6 from its one device there).
* S and L on a ``(2, 2)`` mesh at 128x128 (one pair a data shard,
  ``plan_timestep(3, 2)``, batch 2) against the port's one device: f64
  within 1e-6, f32 within 3e-5 (measured 0 and 3.9e-6 for S). The joint
  mean of both frames is f32 in every dtype and sums over the bands in
  band order, so the f64 gap is f32 rounding.
* An uneven split: 2 x 200x64 in 128 + 72 rows, IFRNet's pad to 256 rows
  in the last band (72 + 56), in f64 within 1e-6 (measured 6.0e-8); the
  rules IFRNet needed ran: ``ResBlock``'s in-place write of the side
  channels (``Tensor.__setitem__``, 8 a forward), the rows of both frames
  joined for their mean (``torch.cat`` along the rows) and the timestep
  map, a plain tensor spanning the rows, in ``torch.cat``.
* ``scale_factor`` 0.5 on a ``(1, 2)`` mesh at 2 x 256x128 in f64 within
  1e-6 (measured 6.0e-8).

One JAX compile (the sharded forward at 128x128).
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from comfyui_frame_interpolation_tpu import parallel as jparallel
from comfyui_frame_interpolation_tpu.core import plan_timestep as jplan_timestep
from comfyui_frame_interpolation_tpu.core import run_plan as jrun_plan
from comfyui_frame_interpolation_tpu.models import ifrnet as jifrnet
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch import parallel
from comfyui_frame_interpolation_tpu_torch.core.loop import run_plan
from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_timestep
from comfyui_frame_interpolation_tpu_torch.models import ifrnet
from comfyui_frame_interpolation_tpu_torch.parallel import space
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

CPU = torch.device("cpu")
JAX_ATOL = 1e-4  # tests/test_parallel.py:132
F32_ATOL = 3e-5
F64_ATOL = 1e-6


def _replicas(n):
    return [CPU] * n


@functools.lru_cache(maxsize=None)
def _params(variant):
    return ifrnet.init_params(variant, 0)


def _make(variant="S", dtype=torch.float32, scale_factor=1.0):
    return lambda d: ifrnet.make_model_fn(_params(variant), variant, scale_factor, dtype=dtype, device=d)


def _frames(h, w, seed=21):
    return np.random.default_rng(seed).random((3, h, w, 3), np.float32)


def _run(frames, make, mesh=None, mids=1, batch_size=2):
    fn = make(CPU) if mesh is None else parallel.make_sharded_model_fn(make, mesh)
    return run_plan(torch.from_numpy(frames), plan_timestep(3, mids + 1), fn, batch_size=batch_size)


def test_ifrnet_on_a_4x2_mesh_matches_jax_sharded():
    frames = _frames(128, 128)
    jmesh = jparallel.make_mesh(8)
    batch = jparallel.frame_sharding(jmesh, (4, 128, 128, 3))
    assert batch.spec == ("data", "space", None, None)
    sharded = jax.jit(
        lambda p, a, b, t: jnp.clip(jifrnet.apply(p, a, b, t, variant="S"), 0.0, 1.0),
        in_shardings=(jparallel.replicated(jmesh), batch, batch, NamedSharding(jmesh, P("data"))),
        out_shardings=jparallel.replicated(jmesh),
    )
    params = to_jax_tree(nest_state_dict(_params("S")))

    def jax_fn(f0, f1, t):
        with jmesh:
            return sharded(params, f0, f1, t)

    ref = np.asarray(jrun_plan(jnp.asarray(frames), jplan_timestep(3, 3), jax_fn, batch_size=4))
    mesh = parallel.make_mesh(8, devices=_replicas(8))
    assert dict(mesh.shape) == {"data": 4, "space": 2}
    out = _run(frames, _make(), mesh, mids=2, batch_size=4)
    assert out.shape == (7, 128, 128, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=JAX_ATOL)


@pytest.mark.parametrize("variant", ["S", "L"])
@pytest.mark.parametrize("dtype, atol", [(torch.float64, F64_ATOL), (torch.float32, F32_ATOL)], ids=["f64", "f32"])
def test_ifrnet_on_a_2x2_mesh_matches_one_device(variant, dtype, atol):
    frames = _frames(128, 128)
    mesh = parallel.make_mesh(4, devices=_replicas(4))
    assert dict(mesh.shape) == {"data": 2, "space": 2}
    ref = _run(frames, _make(variant, dtype))
    out = _run(frames, _make(variant, dtype), mesh)
    assert out.shape == ref.shape == (5, 128, 128, 3) and out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=0, atol=atol)


def test_ifrnet_on_an_uneven_split_matches_one_device(monkeypatch):
    assert space.band_rows(200, 2) == [(0, 128), (128, 72)]
    padded = []
    pad_rule = space._RULES[F.pad]

    def spy(func, args, kwargs):
        out = pad_rule(func, args, kwargs)
        padded.append([b.shape[out.axis] for b in out.bands])
        return out

    monkeypatch.setitem(space._RULES, F.pad, spy)
    ran = {"_setitem": 0, "_cat_rows": 0}

    def counted(name, fn):
        def call(*a, **k):
            ran[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setitem(space._RULES, torch.Tensor.__setitem__, counted("_setitem", space._setitem))
    monkeypatch.setattr(space, "_cat_rows", counted("_cat_rows", space._cat_rows))
    rng = np.random.default_rng(22)
    f0, f1 = (torch.from_numpy(rng.random((2, 200, 64, 3))) for _ in range(2))
    t = torch.tensor([0.3, 0.6])
    make = _make("S", torch.float64)
    ref = make(CPU)(f0, f1, t)
    out = parallel.make_sharded_model_fn(make, parallel.make_mesh(2, devices=_replicas(2)))(f0, f1, t)
    assert padded == [[128, 128], [128, 128]]  # both frames: 200 rows padded to 256, the pad in band 2
    assert ran == {"_setitem": 8, "_cat_rows": 1}  # 4 ResBlocks x 2 writes; the joint mean's rows
    assert out.shape == (2, 200, 64, 3)
    torch.testing.assert_close(out, ref, rtol=0, atol=F64_ATOL)


def test_ifrnet_scale_half_on_a_space_split():
    rng = np.random.default_rng(23)
    f0, f1 = (torch.from_numpy(rng.random((2, 256, 128, 3))) for _ in range(2))
    t = torch.tensor([0.3, 0.6])
    make = _make("S", torch.float64, scale_factor=0.5)
    ref = make(CPU)(f0, f1, t)
    out = parallel.make_sharded_model_fn(make, parallel.make_mesh(2, devices=_replicas(2)))(f0, f1, t)
    torch.testing.assert_close(out, ref, rtol=0, atol=F64_ATOL)
