"""M2M's pair-cached inference on the ``space`` axis of the port's
``parallel/`` (rows split over devices) against the JAX package's GSPMD
split and against the port's own one-device runs, on logical replicas of
the CPU.

* M2M through ``make_sharded_pair_fns`` and ``run_plan_pair_cached`` on a
  ``(4, 2)`` mesh, 3 frames x 256x128 f32, ``plan_timestep(3, 3)`` (2 pairs
  x 2 timesteps, batch 4: each data shard one pair, two bands of 128 rows),
  against JAX's ``parallel.make_sharded_pair_fns`` over its ``(4, 2)``
  virtual mesh through JAX's ``run_plan_pair_cached`` (the configuration of
  ``tests/test_parallel.py:213-254``, made tall enough to split), within its
  1e-4 (measured 1.0e-5 to 1.6e-5, with torch's thread count). At 128x128 JAX's own split is not the JAX
  one-device run: 0.187 apart, on 56 % of the pixels (``ROADMAP.md``
  Queue 3), so the JAX comparison runs at 256 rows, where JAX's split
  agrees with its one device within 1.1e-5.
* The same split at 128x128 (bands of 64 rows) against the port's one
  device: in f64 within 1e-6 (measured 6.0e-8: the splat sums in f32 in
  both, the bands' partials added in another order), so the split computes
  the one device's function; in f32 within 3e-5 (measured 9.7e-6 to
  1.04e-5 here and 1.15e-5 to 1.59e-5 at 256x128, with torch's thread
  count: each f32 run, split or not, is about 1.2e-5 from the f64 run, so
  the gap is f32 rounding of the convolutions' sums in bands, the frame's
  mean and variance from partial sums, and the splat's partials).
* an uneven split: 136 x 64 frames split 128 + 8 rows on a ``(1, 2)`` mesh,
  and M2M's replicate pad to 192 rows lands in the last band (8 + 56 = 64).
* the plain versions' bands: ``warp_torch`` with ``row0`` at M2M's feature
  widths (the wide kernel's twin) is bit for bit the full warp's rows;
  ``softsplat_torch``'s band partials (``row0``, ``out_rows``) over 2 and 3
  bands add up to the whole splat within f32 rounding, on flow that crosses
  the bands' edges and leaves the frame.
* a model with an op over the rows that no rule covers (a running sum
  down the rows, a roll of the rows) raises at that op through
  ``make_sharded_model_fn`` and ``make_sharded_pair_fns``, naming it and the
  ``ROADMAP.md`` item: every family's inference runs on the axis
  (``tests/test_torch_space*.py``), and nothing falls back to a
  data-parallel or whole-frame run.

One JAX compile (the sharded pair functions at 256x128).

``PYTHONPATH=. python tests/test_torch_space_m2m.py`` prints the gaps these
tolerances rest on, at 128x128 and 256x128: JAX's split against JAX's one
device, the port's split against the port's one device in f32 and f64,
and the port against JAX.
"""

import functools
import os
import re

if __name__ == "__main__":  # JAX's virtual CPU mesh, as tests/conftest.py sets it under pytest
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from comfyui_frame_interpolation_tpu import parallel as jparallel
from comfyui_frame_interpolation_tpu.core import plan_timestep as jplan_timestep
from comfyui_frame_interpolation_tpu.core import run_plan_pair_cached as jrun_plan_pair_cached
from comfyui_frame_interpolation_tpu.models import m2m as jm2m
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch import parallel
from comfyui_frame_interpolation_tpu_torch.core.loop import run_plan_pair_cached
from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_timestep
from comfyui_frame_interpolation_tpu_torch.models import m2m
from comfyui_frame_interpolation_tpu_torch.ops.softsplat import softsplat_partial, softsplat_torch
from comfyui_frame_interpolation_tpu_torch.ops.warp import warp_torch
from comfyui_frame_interpolation_tpu_torch.parallel import space
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

CPU = torch.device("cpu")
JAX_ATOL = 1e-4  # tests/test_parallel.py:254
F32_ATOL = 3e-5
F64_ATOL = 1e-6


def _replicas(n):
    return [CPU] * n


@functools.lru_cache(maxsize=None)
def _params():
    return m2m.init_params(0)


def _make(dtype=torch.float32):
    return lambda d: m2m.make_pair_fns(_params(), dtype=dtype, device=d)


def _frames(h, w, seed=20):
    return np.random.default_rng(seed).random((3, h, w, 3), np.float32)


def _run(frames, make, mesh=None, batch_size=4):
    fns = make(CPU) if mesh is None else parallel.make_sharded_pair_fns(make, mesh)
    return run_plan_pair_cached(torch.from_numpy(frames), plan_timestep(3, 3), *fns, batch_size=batch_size)


def _mesh_4x2():
    mesh = parallel.make_mesh(8, devices=_replicas(8))
    assert dict(mesh.shape) == {"data": 4, "space": 2}
    return mesh


def test_m2m_on_a_4x2_mesh_matches_jax_sharded():
    frames = _frames(256, 128)
    jreuse, jinfer = jm2m.make_pair_fns(to_jax_tree(nest_state_dict(_params())))
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
def test_m2m_on_a_4x2_mesh_matches_one_device(dtype, atol):
    frames = _frames(128, 128)
    assert space.band_rows(128, 2) == [(0, 64), (64, 64)]
    ref = _run(frames, _make(dtype))
    out = _run(frames, _make(dtype), _mesh_4x2())
    assert out.shape == ref.shape == (7, 128, 128, 3) and out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=0, atol=atol)


def test_m2m_cache_holds_row_bands():
    """``reuse`` returns each data shard's cache with row-band leaves (the
    frame's mean and standard deviation, which have no rows, stay plain)."""
    f = torch.from_numpy(_frames(128, 64)[:2])
    reuse, _ = parallel.make_sharded_pair_fns(_make(), parallel.make_mesh(2, devices=_replicas(2)))
    (cache,) = reuse(f, f.flip(1))
    banded = {k for k, v in cache.items() if isinstance(v, space.RowBands)}
    assert banded == {"im0_o", "im1_o", "im0_b", "im1_b", "fwd_b", "bwd_b", "metric0", "metric1"}
    assert all(cache[k].starts == (0, 64) and cache[k].axis == 1 for k in banded)
    assert isinstance(cache["mean"], torch.Tensor) and tuple(cache["mean"].shape) == (2, 1, 1, 1)


def test_uneven_split_pads_the_last_band(monkeypatch):
    assert space.band_rows(136, 2) == [(0, 128), (128, 8)]
    padded = []
    pad_rule = space._RULES[F.pad]

    def spy(func, args, kwargs):
        out = pad_rule(func, args, kwargs)
        padded.append((kwargs.get("mode"), [b.shape[out.axis] for b in out.bands]))
        return out

    monkeypatch.setitem(space._RULES, F.pad, spy)
    frames = _frames(136, 64, seed=5)
    ref = _run(frames, _make(), batch_size=2)
    out = _run(frames, _make(), parallel.make_mesh(2, devices=_replicas(2)), batch_size=2)
    # both frames: 136 rows replicate-padded to 192, the pad in band 2
    assert padded[:2] == [("replicate", [128, 64])] * 2
    assert out.shape == (7, 136, 64, 3)
    torch.testing.assert_close(out, ref, rtol=0, atol=F32_ATOL)


# ---- the plain versions' bands ------------------------------------------------------


@pytest.mark.parametrize("mode", ["zeros", "border"])
@pytest.mark.parametrize("c", [32, 48, 96, 192, 384])
def test_warp_torch_band_at_the_wide_widths(c, mode):
    rng = np.random.default_rng(c)
    h = 37
    img = torch.from_numpy(rng.random((2, h, 23, c), np.float32)).contiguous(memory_format=torch.channels_last)
    flow = torch.from_numpy((rng.random((2, h, 23, 2), np.float32) * 2 - 1) * 9)
    full = warp_torch(img, flow, mode)
    for row0, rows in ((0, 18), (18, 19), (h - 1, 1)):
        assert torch.equal(warp_torch(img, flow[:, row0 : row0 + rows], mode, row0=row0), full[:, row0 : row0 + rows])


@pytest.mark.parametrize("spans", [((0, 20), (20, 17)), ((0, 12), (12, 13), (25, 12))])
@pytest.mark.parametrize("c", [1, 4, 7])
def test_softsplat_torch_band_partials_sum_to_the_whole(spans, c):
    rng = np.random.default_rng(len(spans) * 10 + c)
    h, w = 37, 29
    vals = torch.from_numpy(rng.random((2, h, w, c), np.float32))
    flow = torch.from_numpy((rng.random((2, h, w, 2), np.float32) * 2 - 1) * 15)  # across the bands and off the frame
    flow[0, 3, 4] = float("nan")
    whole = softsplat_torch(vals, flow)
    assert torch.equal(softsplat_torch(vals, flow, row0=0, out_rows=h), whole)
    total = torch.zeros_like(whole)
    for row0, rows in spans:
        part = softsplat_torch(vals[:, row0 : row0 + rows], flow[:, row0 : row0 + rows], row0=row0, out_rows=h)
        assert part.shape == (2, h, w, c)
        assert torch.equal(softsplat_partial(vals[:, row0 : row0 + rows], flow[:, row0 : row0 + rows], row0, h), part)
        total += part
    torch.testing.assert_close(total, whole, rtol=0, atol=1e-6)


def test_softsplat_band_outside_the_frame_raises():
    vals, flow = torch.zeros(1, 8, 8, 4), torch.zeros(1, 8, 8, 2)
    with pytest.raises(ValueError, match="does not lie within"):
        softsplat_torch(vals, flow, row0=4, out_rows=10)


# ---- an op without a rule ----------------------------------------------------------------

NO_RULES = {  # ops over the rows that no family uses, and the names their refusals give
    "cumsum": (lambda f: f.cumsum(1), "Tensor.cumsum"),  # a running sum down the rows
    "roll": (lambda f: torch.roll(f, 1, 1), "_VariableFunctionsClass.roll"),  # the rows moved round the frame
}


@pytest.mark.parametrize("wrapper", ["model_fn", "pair_fns"])
@pytest.mark.parametrize("op", list(NO_RULES))
def test_a_pair_split_without_rules_raises(op, wrapper):
    """A frame pair split over the rows (``make_sharded_model_fn``, or the
    pair-cached ``make_sharded_pair_fns``) of a model whose op the rules do
    not cover raises at that op, naming it and the ``ROADMAP.md`` item (every
    family's inference runs on the axis: ``tests/test_torch_space*.py``)."""
    op_fn, name = NO_RULES[op]
    mesh = parallel.make_mesh(2, devices=_replicas(2))
    f = torch.rand(2, 128, 64, 3)
    if wrapper == "model_fn":
        fn = parallel.make_sharded_model_fn(lambda d: (lambda a, b, t: op_fn(a)), mesh)
        call = lambda: fn(f, f, torch.full((2,), 0.5))  # noqa: E731
    else:
        reuse, _ = parallel.make_sharded_pair_fns(lambda d: ((lambda a, b: op_fn(a)), (lambda a, b, c, t: c)), mesh)
        call = lambda: reuse(f, f)  # noqa: E731
    with pytest.raises(NotImplementedError, match=f"^{re.escape(name)} has no row-band rule: .*ROADMAP.md Queue 1 item 3"):
        call()


def _gaps(h, w):
    """``{name: max abs gap}`` of M2M's runs at 3 x ``h`` x ``w``: JAX and the
    port, each split on its ``(4, 2)`` mesh and on one device, and the
    port's in f64."""
    frames = _frames(h, w)
    jreuse, jinfer = jm2m.make_pair_fns(to_jax_tree(nest_state_dict(_params())))
    split = jparallel.make_sharded_pair_fns(jreuse, jinfer, jparallel.make_mesh(8))
    plan = jplan_timestep(3, 3)
    jax_split = np.asarray(jrun_plan_pair_cached(jnp.asarray(frames), plan, *split, batch_size=4))
    jax_one = np.asarray(jrun_plan_pair_cached(jnp.asarray(frames), plan, jreuse, jinfer, batch_size=4))
    port = {dt: (_run(frames, _make(dt)).numpy(), _run(frames, _make(dt), _mesh_4x2()).numpy()) for dt in (torch.float32, torch.float64)}
    gap = lambda a, b: float(np.abs(a - b).max())  # noqa: E731
    return {
        "jax split vs jax one device": gap(jax_split, jax_one),
        "jax split vs jax one device, values above 1e-4": int((np.abs(jax_split - jax_one) > 1e-4).sum()),
        "values": int(jax_one.size),
        "port split vs port one device, f32": gap(*port[torch.float32][::-1]),
        "port split vs port one device, f64": gap(*port[torch.float64][::-1]),
        "port split vs jax split": gap(port[torch.float32][1], jax_split),
        "port one device vs jax one device": gap(port[torch.float32][0], jax_one),
    }


if __name__ == "__main__":
    for hw in ((128, 128), (256, 128)):
        print(f"{hw[0]}x{hw[1]}:", _gaps(*hw), flush=True)
