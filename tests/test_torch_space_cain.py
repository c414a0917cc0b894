"""CAIN on the ``space`` axis of the port's ``parallel/`` (rows split over
devices) through ``make_sharded_model_fn`` and ``run_plan``, against the
JAX package's GSPMD split and against the port's own one-device runs, on
logical replicas of the CPU.

At 136 rows the port splits 128 + 8 and CAIN reflect-pads the rows,
centred, to 256: 60 rows on top and 60 below. The last band's 8 rows take
a pad of 60, which it reads from its neighbour (numpy's reflection), and
the second band then starts at row 188, which ``pixel_unshuffle(8)``
cannot split (188 = 8 x 23.5): the re-banding rule moves the edge to 184
first. Every one of the trunk's 125 convolutions pads through
``cain._reflect_pad1``, whose rule gives each band a row of halo from each
neighbour and a reflected row at the global top and bottom only.

* On a ``(4, 2)`` mesh, 3 frames x 136x64 f32, ``plan_timestep(3, 3)``
  (batch 4: each data shard one pair), through ``run_plan``, against JAX's
  ``apply`` jitted with the frames sharded over its ``(4, 2)`` virtual mesh
  by ``frame_sharding`` (the weights an argument), through JAX's
  ``run_plan``: within ``tests/test_parallel.py``'s 1e-4 (measured
  2.1e-6; JAX's split is 1.0e-6 from its one device there).
* On a ``(2, 2)`` mesh at b4 x 136x64 in f64 (``apply`` in f64, f64 out)
  against the port's one device: within 1e-12 (measured 1.7e-15), the
  edge moved once per frame.
* On a ``(1, 2)`` mesh at 3 frames x 136x64 f32 through ``run_plan``
  against the port's one device: within 1e-5 (measured 2.0e-6: f32
  rounding of the convolutions' sums in bands).

One JAX compile (the sharded forward at 136x64).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from comfyui_frame_interpolation_tpu import parallel as jparallel
from comfyui_frame_interpolation_tpu.core import plan_timestep as jplan_timestep
from comfyui_frame_interpolation_tpu.core import run_plan as jrun_plan
from comfyui_frame_interpolation_tpu.models import cain as jcain
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch import parallel
from comfyui_frame_interpolation_tpu_torch.core.loop import run_plan
from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_timestep
from comfyui_frame_interpolation_tpu_torch.models import cain
from comfyui_frame_interpolation_tpu_torch.parallel import space
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

CPU = torch.device("cpu")
JAX_ATOL = 1e-4  # tests/test_parallel.py:132
F32_ATOL = 1e-5
F64_ATOL = 1e-12
H, W = 136, 64


def _replicas(n):
    return [CPU] * n


@functools.lru_cache(maxsize=None)
def _params():
    return cain.init_params(0)


def _make(device):
    return cain.make_model_fn(_params(), device=device)


def _make_f64(device):
    """``cain.apply`` in f64 with f64 out."""
    net = cain._load(_params(), torch.float64, device)

    @torch.inference_mode()
    def model_fn(f0, f1, t=None):
        x0, x1 = (f.to(device=device, dtype=torch.float64).permute(0, 3, 1, 2) for f in (f0, f1))
        return cain.apply(net, x0, x1).permute(0, 2, 3, 1)

    return model_fn


def _frames(seed=30):
    return np.random.default_rng(seed).random((3, H, W, 3), np.float32)


def test_cain_on_a_4x2_mesh_matches_jax_sharded():
    frames = _frames()
    jmesh = jparallel.make_mesh(8)
    batch = jparallel.frame_sharding(jmesh, (4, H, W, 3))
    assert batch.spec == ("data", "space", None, None)
    sharded = jax.jit(
        lambda p, a, b: jcain.apply(p, a, b),
        in_shardings=(jparallel.replicated(jmesh), batch, batch),
        out_shardings=jparallel.replicated(jmesh),
    )
    params = to_jax_tree(nest_state_dict(_params()))

    def jax_fn(f0, f1, t):
        with jmesh:
            return sharded(params, f0, f1)

    ref = np.asarray(jrun_plan(jnp.asarray(frames), jplan_timestep(3, 3), jax_fn, batch_size=4))
    mesh = parallel.make_mesh(8, devices=_replicas(8))
    assert dict(mesh.shape) == {"data": 4, "space": 2}
    out = run_plan(torch.from_numpy(frames), plan_timestep(3, 3), parallel.make_sharded_model_fn(_make, mesh), batch_size=4)
    assert out.shape == (7, H, W, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=JAX_ATOL)


def test_cain_on_a_2x2_mesh_matches_one_device_in_f64(monkeypatch):
    """The reflect pad puts the second band at row 188 and ``pixel_unshuffle``
    moves it to 184, once per frame of each data shard."""
    seen = []
    rule = space._RULES[torch.pixel_unshuffle]

    def spy(func, args, kwargs):
        seen.append(args[0].starts)
        return rule(func, args, kwargs)

    monkeypatch.setitem(space._RULES, torch.pixel_unshuffle, spy)
    rng = np.random.default_rng(31)
    f0, f1 = (torch.from_numpy(rng.random((4, H, W, 3))) for _ in range(2))
    ref = _make_f64(CPU)(f0, f1)
    mesh = parallel.make_mesh(4, devices=_replicas(4))
    assert dict(mesh.shape) == {"data": 2, "space": 2}
    space.rebands = space.rows_moved = 0
    out = parallel.make_sharded_model_fn(_make_f64, mesh)(f0, f1, torch.full((4,), 0.5))
    assert seen == [(0, 188)] * 4
    assert (space.rebands, space.rows_moved) == (4, 4 * 4)
    assert out.shape == ref.shape == (4, H, W, 3) and out.dtype == torch.float64
    torch.testing.assert_close(out, ref, rtol=0, atol=F64_ATOL)


def test_cain_on_a_1x2_mesh_matches_one_device():
    frames = torch.from_numpy(_frames(32))
    plan = plan_timestep(3, 2)
    ref = run_plan(frames, plan, _make(CPU), batch_size=2)
    mesh = parallel.make_mesh(2, devices=_replicas(2))
    out = run_plan(frames, plan, parallel.make_sharded_model_fn(_make, mesh), batch_size=2)
    assert out.shape == ref.shape == (5, H, W, 3)
    torch.testing.assert_close(out, ref, rtol=0, atol=F32_ATOL)
