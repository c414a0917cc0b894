"""XVFI (Vimeo)'s pair-cached inference on the ``space`` axis of the port's
``parallel/`` (rows split over devices) against the JAX package's GSPMD
split and against the port's own one-device runs, on logical replicas of
the CPU.

* XVFI Vimeo through ``make_sharded_pair_fns`` and ``run_plan_pair_cached``
  on a ``(4, 2)`` mesh, 3 frames x 256x128 f32, ``plan_timestep(3, 3)``
  (2 pairs x 2 timesteps, batch 4: each data shard one pair, two bands of
  128 rows), against JAX's ``parallel.make_sharded_pair_fns`` over its
  ``(4, 2)`` virtual mesh through JAX's ``run_plan_pair_cached`` (the
  configuration of ``tests/test_parallel.py:213-254``, made tall enough to
  split), within its 1e-4 (measured 9.0e-6; JAX's split is 6.5e-6 from its
  one device there, so unlike M2M's at 128 rows it needs no other size).
* The same split at 128x128 (bands of 64 rows) against the port's one
  device: in f64 within 1e-6 (measured 1.2e-7: the splat sums in f32 in
  both, the bands' partials added in another order), so the split computes
  the one device's function; in f32 within 3e-5 (measured 2.7e-6: f32
  rounding of the convolutions' sums in bands and of the splat's
  partials).
* an uneven split: 136 x 64 frames split 128 + 8 rows on a ``(1, 2)``
  mesh, and XVFI's zero pad to 144 rows (a multiple of 16) lands in the
  last band (8 + 8 = 16 rows); measured 2.9e-6 from one device in f32.
* ``reuse`` returns each data shard's cache as row bands: level 0's
  features and both flow tensors, on the half-resolution rows.

The rules XVFI needed (``relu``, ``floor``, ``stack``, an index with
``None``, nearest ``interpolate``, the warp of a plain source) are held one
at a time on 2 and 3 bands in ``tests/test_torch_space.py``. XVFI X4K
(``S_tst`` 5), whose coarse levels start the second band off their stride
(the re-banding rule): ``tests/test_torch_space_x4k.py``.

One JAX compile (the sharded pair functions at 256x128).
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
CKPT = "XVFInet_Vimeo_exp1_latest.pt"
JAX_ATOL = 1e-4  # tests/test_parallel.py:254
F32_ATOL = 3e-5
F64_ATOL = 1e-6


def _replicas(n):
    return [CPU] * n


@functools.lru_cache(maxsize=None)
def _params():
    return xvfi.init_params(CKPT, 0)


def _make(dtype=torch.float32):
    return lambda d: xvfi.make_pair_fns(_params(), CKPT, dtype=dtype, device=d)


def _frames(h, w, seed=20):
    return np.random.default_rng(seed).random((3, h, w, 3), np.float32)


def _run(frames, make, mesh=None, batch_size=4):
    fns = make(CPU) if mesh is None else parallel.make_sharded_pair_fns(make, mesh)
    return run_plan_pair_cached(torch.from_numpy(frames), plan_timestep(3, 3), *fns, batch_size=batch_size)


def _mesh_4x2():
    mesh = parallel.make_mesh(8, devices=_replicas(8))
    assert dict(mesh.shape) == {"data": 4, "space": 2}
    return mesh


def test_xvfi_on_a_4x2_mesh_matches_jax_sharded():
    frames = _frames(256, 128)
    jreuse, jinfer = jxvfi.make_pair_fns(to_jax_tree(nest_state_dict(_params())), CKPT)
    jmesh = jparallel.make_mesh(8)
    assert jparallel.frame_sharding(jmesh, frames.shape).spec == ("data", "space", None, None)
    sreuse, sinfer = jparallel.make_sharded_pair_fns(jreuse, jinfer, jmesh)
    ref = np.asarray(jrun_plan_pair_cached(jnp.asarray(frames), jplan_timestep(3, 3), sreuse, sinfer, batch_size=4))
    mesh = _mesh_4x2()
    assert parallel.frame_sharding(mesh, frames.shape).spec == ("data", "space", None, None)
    out = _run(frames, _make(), mesh)
    assert out.shape == (7, 256, 128, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=JAX_ATOL)


@pytest.mark.parametrize("dtype, atol", [(torch.float64, F64_ATOL), (torch.float32, F32_ATOL)])
def test_xvfi_on_a_4x2_mesh_matches_one_device(dtype, atol):
    frames = _frames(128, 128)
    assert space.band_rows(128, 2) == [(0, 64), (64, 64)]
    ref = _run(frames, _make(dtype))
    out = _run(frames, _make(dtype), _mesh_4x2())
    assert out.shape == ref.shape == (7, 128, 128, 3) and out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=0, atol=atol)


def test_xvfi_cache_holds_row_bands():
    """``reuse`` returns each data shard's cache, ``(level 0's features,
    flow, flow_tmp)``, as NCHW row bands at half the frame's rows."""
    f = torch.from_numpy(_frames(128, 64)[:2])
    reuse, _ = parallel.make_sharded_pair_fns(_make(), parallel.make_mesh(2, devices=_replicas(2)))
    (cache,) = reuse(f, f.flip(1))
    assert len(cache) == 3 and all(isinstance(v, space.RowBands) for v in cache)
    assert all(v.starts == (0, 32) and v.axis == 2 and v.height == 64 for v in cache)
    feat, flow, flow_tmp = cache
    assert tuple(feat.shape) == (4, 64, 64, 32) and tuple(flow.shape) == (2, 4, 64, 32) and tuple(flow_tmp.shape) == (2, 6, 64, 32)


def test_uneven_split_pads_the_last_band(monkeypatch):
    assert space.band_rows(136, 2) == [(0, 128), (128, 8)]
    padded = []
    pad_rule = space._RULES[F.pad]

    def spy(func, args, kwargs):
        out = pad_rule(func, args, kwargs)
        padded.append([b.shape[out.axis] for b in out.bands])
        return out

    monkeypatch.setitem(space._RULES, F.pad, spy)
    frames = _frames(136, 64, seed=5)
    ref = _run(frames, _make(), batch_size=2)
    out = _run(frames, _make(), parallel.make_mesh(2, devices=_replicas(2)), batch_size=2)
    # both frames of reuse and of infer: 136 rows zero-padded to 144, the pad in band 2
    assert padded[:4] == [[128, 16]] * 4
    assert out.shape == (7, 136, 64, 3)
    torch.testing.assert_close(out, ref, rtol=0, atol=F32_ATOL)
