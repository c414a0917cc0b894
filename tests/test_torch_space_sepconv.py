"""Sepconv on the ``space`` axis of the port's ``parallel/`` (rows split
over devices) through ``make_sharded_model_fn`` and ``run_plan``, against
the JAX package's GSPMD split and against the port's own one-device runs,
on logical replicas of the CPU, with the conditioned weights
(``chip_smoke.sepconv_conditioned``: raw random weights leave the
normaliser near 0).

At 133 rows (odd) the port splits 128 + 5; the edge pad to 134 rows lands
in the last band, the frame statistics are one ``std_mean`` over every
non-batch dimension of the stacked frames (partial sums in band order),
and ``sepconv_func`` reads the 25 rows above and below each band's output
rows from its neighbours, the replicate pad of 25 in the first and last
bands only. The port's edges lie on multiples of 64 rows, which Sepconv's
four halvings keep whole, so its own split moves no rows; edges off them
(an even split, as GSPMD cuts 133 rows: 67 + 66) give the odd levels'
crops (``models/sepconv.py:135``) bands other than the level's, which the
re-banding rule moves.

* On a ``(4, 2)`` mesh, 3 frames x 138x64 f32, ``plan_timestep(3, 3)``
  (batch 4: each data shard one pair), through ``run_plan``, against JAX's
  ``apply`` jitted with the frames sharded over its ``(4, 2)`` virtual mesh
  by ``frame_sharding`` (the weights an argument), through JAX's
  ``run_plan``: within ``tests/test_parallel.py``'s 1e-4 (measured
  1.4e-6; JAX's split is 2.4e-7 from its one device). JAX's sharding
  refuses 133 rows (a height the ``space`` axis does not divide), so this
  case takes 138, whose levels of 69, 35, 18 and 9 rows crop the
  upsampled ones too.
* On a ``(2, 2)`` mesh at b4 x 133x64 in f64 (``apply`` in f64, f64 out)
  against the port's one device: within 1e-6 (``sepconv_func`` sums in
  f32 in every dtype; measured 0); no re-band.
* The even split (67 + 66 rows) on a ``(1, 2)`` mesh in f64: within 1e-6
  (measured 0), and the crops' bands re-banded (2 re-bands, 2 rows).

One JAX compile (the sharded forward at 138x64).
"""

import functools
import os
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu import parallel as jparallel
from comfyui_frame_interpolation_tpu.core import plan_timestep as jplan_timestep
from comfyui_frame_interpolation_tpu.core import run_plan as jrun_plan
from comfyui_frame_interpolation_tpu.models import sepconv as jsepconv
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch import parallel
from comfyui_frame_interpolation_tpu_torch.core.loop import run_plan
from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_timestep
from comfyui_frame_interpolation_tpu_torch.models import sepconv
from comfyui_frame_interpolation_tpu_torch.parallel import space
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the script at the repository's root; it imports nothing heavy)

CPU = torch.device("cpu")
JAX_ATOL = 1e-4  # tests/test_parallel.py:132
F64_ATOL = 1e-6
H, W = 133, 64
JAX_H = 138  # JAX's sharding refuses rows that the space axis does not divide


def _replicas(n):
    return [CPU] * n


@functools.lru_cache(maxsize=None)
def _params():
    return chip_smoke.sepconv_conditioned(0)


def _make(device):
    return sepconv.make_model_fn(_params(), device=device)


def _make_f64(device):
    """``sepconv.apply`` in f64 with f64 out."""
    net = sepconv._load(_params(), torch.float64, device)

    @torch.inference_mode()
    def model_fn(f0, f1, t=None):
        x0, x1 = (f.to(device=device, dtype=torch.float64).permute(0, 3, 1, 2) for f in (f0, f1))
        return sepconv.apply(net, x0, x1).permute(0, 2, 3, 1)

    return model_fn


def _frames(h, seed=40):
    return np.random.default_rng(seed).random((3, h, W, 3), np.float32)


def _f64_pair(seed, n=4):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.random((n, H, W, 3))) for _ in range(2))


def test_sepconv_on_a_4x2_mesh_matches_jax_sharded():
    frames = _frames(JAX_H)
    jmesh = jparallel.make_mesh(8)
    batch = jparallel.frame_sharding(jmesh, (4, JAX_H, W, 3))
    assert batch.spec == ("data", "space", None, None)
    sharded = jax.jit(
        lambda p, a, b: jsepconv.apply(p, a, b),
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
    assert out.shape == (7, JAX_H, W, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=JAX_ATOL)


def test_sepconv_on_a_2x2_mesh_matches_one_device_in_f64():
    f0, f1 = _f64_pair(41)
    ref = _make_f64(CPU)(f0, f1)
    mesh = parallel.make_mesh(4, devices=_replicas(4))
    assert dict(mesh.shape) == {"data": 2, "space": 2}
    assert space.band_rows(H, 2) == [(0, 128), (128, 5)]
    space.rebands = 0
    out = parallel.make_sharded_model_fn(_make_f64, mesh)(f0, f1, torch.full((4,), 0.5))
    assert space.rebands == 0
    assert out.shape == ref.shape == (4, H, W, 3) and out.dtype == torch.float64
    torch.testing.assert_close(out, ref, rtol=0, atol=F64_ATOL)


def test_sepconv_on_an_even_split_rebands_the_crops(monkeypatch):
    even = functools.partial(space.band_rows, unit=1)
    assert even(H, 2) == [(0, 67), (67, 66)]
    monkeypatch.setattr(space, "band_rows", even)
    f0, f1 = _f64_pair(42, 2)
    ref = _make_f64(CPU)(f0, f1)
    space.rebands = space.rows_moved = 0
    out = parallel.make_sharded_model_fn(_make_f64, parallel.make_mesh(2, devices=_replicas(2)))(f0, f1, torch.full((2,), 0.5))
    assert space.rebands > 0 and space.rows_moved > 0
    torch.testing.assert_close(out, ref, rtol=0, atol=F64_ATOL)
