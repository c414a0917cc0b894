"""XVFI X4K's pair-cached inference on the ``space`` axis of the port's
``parallel/`` (rows split over devices) through ``make_sharded_pair_fns``
and ``run_plan_pair_cached``, against the JAX package and against the
port's own one-device runs, on logical replicas of the CPU.

X4K pads frames to multiples of 512 rows and builds its pyramid down to
1/128 of them. At 320 rows the port splits 192 + 128 (the pad to 512 in
the last band), so the second band starts at 1.5 rows at 1/128: the
strided convolutions own the rows from ``ceil(start / 2)`` and the
upsampled flows from twice the coarser start, two values of one height in
other bands that meet at the warps, the channel ``cat``\\ s and the flow
sums, where the re-banding rule moves the second onto the first's edges
(11 re-bands per reuse and infer at b2). The coarsest flow net's second
4x4 stride-2 convolution makes one row from the 1/128 level's 4 (fewer
than the two bands): its second band holds no rows until the nearest
upsample gives it one again.

JAX's own split of X4K (``parallel.make_sharded_pair_fns`` on its ``(4,
2)`` virtual mesh) is 0.61-0.66 from its one device at every size tried
(320x64, 576x64, 1024x64 and 512x512: ``python
tests/test_torch_space_x4k.py`` prints the gaps; ``ROADMAP.md`` Queue 3),
while the port's one device is within 1e-4 of JAX's one device. So the
port's split is held against JAX's one device:

* on a ``(4, 2)`` mesh, 3 frames x 320x64 f32, ``plan_timestep(3, 3)``
  (2 pairs x 2 timesteps, batch 4: each data shard one pair), against
  JAX's one-device pair functions through JAX's ``run_plan_pair_cached``:
  within 1e-4;
* on a ``(2, 2)`` mesh at 3 frames x 320x64, ``plan_timestep(3, 2)``
  (batch 2), in f64 against the port's one device within 1e-6 (the splat
  sums in f32 in both, the bands' partials in another order; XVFI's
  output is f32 in every dtype), with the re-bands counted and each data
  shard's cache held as row bands.

One JAX compile (the one-device pair functions at 320x64).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from comfyui_frame_interpolation_tpu import parallel as jparallel
from comfyui_frame_interpolation_tpu.core import plan_timestep as jplan_timestep
from comfyui_frame_interpolation_tpu.core import run_plan_pair_cached as jrun_plan_pair_cached
from comfyui_frame_interpolation_tpu.models import xvfi as jxvfi
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch import parallel
from comfyui_frame_interpolation_tpu_torch.core.loop import run_plan_pair_cached
from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_timestep
from comfyui_frame_interpolation_tpu_torch.models import xvfi
from comfyui_frame_interpolation_tpu_torch.parallel import space
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

CPU = torch.device("cpu")
CKPT = "XVFInet_X4K1000FPS_exp1_latest.pt"
JAX_ATOL = 1e-4  # tests/test_parallel.py:254
F64_ATOL = 1e-6
H, W = 320, 64


def _replicas(n):
    return [CPU] * n


@functools.lru_cache(maxsize=None)
def _params():
    return xvfi.init_params(CKPT, 0)


def _make(dtype=torch.float32):
    return lambda d: xvfi.make_pair_fns(_params(), CKPT, dtype=dtype, device=d)


def _frames(h=H, w=W, seed=50):
    return np.random.default_rng(seed).random((3, h, w, 3), np.float32)


def _run(frames, make, mesh=None, mids=2, batch_size=4):
    fns = make(CPU) if mesh is None else parallel.make_sharded_pair_fns(make, mesh)
    return run_plan_pair_cached(torch.from_numpy(frames), plan_timestep(3, mids + 1), *fns, batch_size=batch_size)


def _jax_runs(frames, split):
    """JAX's output through ``run_plan_pair_cached`` at ``plan_timestep(3,
    3)``, batch 4: on one device, or split on its ``(4, 2)`` mesh."""
    fns = jxvfi.make_pair_fns(to_jax_tree(nest_state_dict(_params())), CKPT)
    if split:
        jmesh = jparallel.make_mesh(8)
        assert jparallel.frame_sharding(jmesh, frames.shape).spec == ("data", "space", None, None)
        fns = jparallel.make_sharded_pair_fns(*fns, jmesh)
    return np.asarray(jrun_plan_pair_cached(jnp.asarray(frames), jplan_timestep(3, 3), *fns, batch_size=4))


def test_x4k_on_a_4x2_mesh_matches_jax_one_device():
    frames = _frames()
    ref = _jax_runs(frames, split=False)
    mesh = parallel.make_mesh(8, devices=_replicas(8))
    assert dict(mesh.shape) == {"data": 4, "space": 2}
    assert parallel.frame_sharding(mesh, frames.shape).spec == ("data", "space", None, None)
    out = _run(frames, _make(), mesh)
    assert out.shape == (7, H, W, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=JAX_ATOL)


def test_x4k_on_a_2x2_mesh_matches_one_device_in_f64():
    frames = _frames(seed=51)
    mesh = parallel.make_mesh(4, devices=_replicas(4))
    assert dict(mesh.shape) == {"data": 2, "space": 2}
    assert space.band_rows(H, 2) == [(0, 192), (192, 128)]
    ref = _run(frames, _make(torch.float64), mids=1, batch_size=2)
    space.rebands = space.rows_moved = 0
    out = _run(frames, _make(torch.float64), mesh, mids=1, batch_size=2)
    assert space.rebands == 2 * 11 and space.rows_moved > 0  # each data shard's reuse and infer
    assert out.shape == ref.shape == (5, H, W, 3) and out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=0, atol=F64_ATOL)


def test_x4k_cache_holds_row_bands():
    """``reuse`` returns each data shard's cache, ``(level 0's features,
    flow, flow_tmp)``, as NCHW row bands at a quarter of the padded rows."""
    f = torch.from_numpy(_frames()[:2])
    reuse, _ = parallel.make_sharded_pair_fns(_make(), parallel.make_mesh(2, devices=_replicas(2)))
    (cache,) = reuse(f, f.flip(1))
    assert len(cache) == 3 and all(isinstance(v, space.RowBands) for v in cache)
    assert all(v.axis == 2 and v.height == 128 for v in cache)
    feat, flow, flow_tmp = cache
    assert tuple(feat.shape) == (4, 64, 128, 128) and tuple(flow.shape) == (2, 4, 128, 128)


if __name__ == "__main__":
    for hw in ((320, 64), (512, 512)):
        fr = _frames(*hw)
        one, split = _jax_runs(fr, False), _jax_runs(fr, True)
        port = run_plan_pair_cached(torch.from_numpy(fr), plan_timestep(3, 3), *_make()(CPU), batch_size=4).numpy()
        print(f"{hw[0]}x{hw[1]}: jax split vs jax one device {float(np.abs(split - one).max())}, "
              f"port one device vs jax one device {float(np.abs(port - one).max())}", flush=True)
