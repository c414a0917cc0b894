"""FLAVR 2x on the ``space`` axis of the port's ``parallel/`` (rows split
over devices) through ``make_sharded_model_fn`` and ``run_plan_window4``,
against the JAX package's GSPMD split and against the port's own one-device
runs, on logical replicas of the CPU.

FLAVR stacks the four NHWC frames into an NCDHW clip, so the rows land on
dimension 3 of every 3-D convolution: the stem ``(3, 7, 7)`` at stride
``(1, 2, 2)``, the 3x3x3 blocks, the strided blocks with their 1x1x1
downsample, the decoder's ``conv_transpose3d`` ``(3, 4, 4)``; the
SEGating means over ``(2, 3, 4)`` come from partial sums in band order; the
time-channel merge ``reshape(b, h, w, t * c)`` changes only the dimensions
after the rows.

* On a ``(4, 2)`` mesh, 7 frames x 128x64 f32, ``plan_window4(7)`` (4
  windows at batch 4: each data shard one window, two bands of 64 rows),
  through ``run_plan_window4``, against JAX's ``flavr.apply`` jitted with
  the frames sharded over its ``(4, 2)`` virtual mesh by
  ``frame_sharding`` (the weights an argument), through JAX's
  ``run_plan_window4``: within ``tests/test_parallel.py``'s 1e-4 (measured
  1.2e-7; JAX's split is 1.2e-7 from JAX's one device there).
* On a ``(2, 2)`` mesh at b2 x 144x64 in f64 (``apply`` in f64, f64 out)
  against the port's one device: within 1e-12, as every op is a convolution,
  a pad or a mean in f64 (measured 2.2e-16). 144 rows split
  128 + 16, which the strided convolutions take to 64 + 8, 32 + 4 and
  16 + 2 rows at 1/8.
* On a ``(1, 2)`` mesh at 5 frames x 144x64 f32 through
  ``run_plan_window4`` against the port's one device: within 1e-5
  (measured 6.0e-8: f32 rounding of the convolutions' sums in bands).

FLAVR launches no hand kernel. One JAX compile (the sharded ``apply`` at
128x64).
"""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu import parallel as jparallel
from comfyui_frame_interpolation_tpu.core import plan_window4 as jplan_window4
from comfyui_frame_interpolation_tpu.core import run_plan_window4 as jrun_plan_window4
from comfyui_frame_interpolation_tpu.models import flavr as jflavr
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch import parallel
from comfyui_frame_interpolation_tpu_torch.core.loop import run_plan_window4
from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_window4
from comfyui_frame_interpolation_tpu_torch.models import flavr
from comfyui_frame_interpolation_tpu_torch.parallel import space
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

CPU = torch.device("cpu")
JAX_ATOL = 1e-4  # tests/test_parallel.py:132
F32_ATOL = 1e-5
F64_ATOL = 1e-12


def _replicas(n):
    return [CPU] * n


@functools.lru_cache(maxsize=None)
def _params():
    return flavr.init_params(0)


def _make(device):
    return flavr.make_model_fn(_params(), device=device)


def _make_f64(device):
    """``flavr.apply`` in f64 with f64 out."""
    net = flavr._load(_params(), torch.float64, device)

    @torch.inference_mode()
    def model_fn(f0, f1, f2, f3):
        clip = torch.stack([f.to(device=device, dtype=torch.float64) for f in (f0, f1, f2, f3)], 1)
        return flavr.apply(net, clip.permute(0, 4, 1, 2, 3))[0].permute(0, 2, 3, 1)

    return model_fn


def _frames(n, h, seed):
    return np.random.default_rng(seed).random((n, h, 64, 3), np.float32)


def test_flavr_on_a_4x2_mesh_matches_jax_sharded():
    frames = _frames(7, 128, 40)
    jmesh = jparallel.make_mesh(8)
    batch = jparallel.frame_sharding(jmesh, (4, 128, 64, 3))
    assert batch.spec == ("data", "space", None, None)
    sharded = jax.jit(
        lambda p, a, b, c, d: jflavr.apply(p, jnp.stack([a, b, c, d], 1), 1)[0],
        in_shardings=(jparallel.replicated(jmesh), batch, batch, batch, batch),
        out_shardings=jparallel.replicated(jmesh),
    )
    params = to_jax_tree(nest_state_dict(_params()))

    def jax_fn(f0, f1, f2, f3):
        with jmesh:
            return sharded(params, f0, f1, f2, f3)

    ref = np.asarray(jrun_plan_window4(jnp.asarray(frames), jplan_window4(7), jax_fn, batch_size=4))
    mesh = parallel.make_mesh(8, devices=_replicas(8))
    assert dict(mesh.shape) == {"data": 4, "space": 2}
    out = run_plan_window4(
        torch.from_numpy(frames), plan_window4(7), parallel.make_sharded_model_fn(_make, mesh), batch_size=4
    )
    assert out.shape == (11, 128, 64, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=JAX_ATOL)


def test_flavr_on_a_2x2_mesh_matches_one_device_in_f64(monkeypatch):
    """144 rows split 128 + 16; the strided 3-D convolutions halve both
    bands down to 16 + 2 rows at 1/8 of the frame."""
    seen = set()
    rule = space._RULES[torch.conv3d]

    def spy(func, args, kwargs):
        x = args[0]
        seen.add((x.starts, x.height, x.axis))
        return rule(func, args, kwargs)

    monkeypatch.setitem(space._RULES, torch.conv3d, spy)
    rng = np.random.default_rng(41)
    f = [torch.from_numpy(rng.random((2, 144, 64, 3))) for _ in range(4)]
    ref = _make_f64(CPU)(*f)
    mesh = parallel.make_mesh(4, devices=_replicas(4))
    assert dict(mesh.shape) == {"data": 2, "space": 2}
    out = parallel.make_sharded_model_fn(_make_f64, mesh)(*f)
    assert {(s, h) for s, h, _ in seen} >= {((0, 128), 144), ((0, 64), 72), ((0, 32), 36), ((0, 16), 18)}
    assert {a for _, _, a in seen} == {3}  # the rows on dimension 3 of the NCDHW clips
    assert out.shape == ref.shape == (2, 144, 64, 3) and out.dtype == torch.float64
    torch.testing.assert_close(out, ref, rtol=0, atol=F64_ATOL)


def test_flavr_on_a_1x2_mesh_matches_one_device():
    frames = torch.from_numpy(_frames(5, 144, 42))
    plan = plan_window4(5)
    ref = run_plan_window4(frames, plan, _make(CPU), batch_size=2)
    mesh = parallel.make_mesh(2, devices=_replicas(2))
    out = run_plan_window4(frames, plan, parallel.make_sharded_model_fn(_make, mesh), batch_size=2)
    assert out.shape == ref.shape == (7, 144, 64, 3)
    torch.testing.assert_close(out, ref, rtol=0, atol=F32_ATOL)
