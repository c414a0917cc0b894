"""AMT on the ``space`` axis of the port's ``parallel/`` (rows split over
devices) through ``make_sharded_model_fn`` and ``run_plan``, against the
JAX package's GSPMD split and against the port's own one-device runs, on
logical replicas of the CPU.

* AMT-S on a ``(4, 2)`` mesh, 3 frames x 128x128 f32, ``plan_timestep(3,
  3)`` (batch 4: each data shard one pair, two bands of 64 rows), against
  JAX's ``apply`` jitted with the frames sharded over its ``(4, 2)``
  virtual mesh by ``frame_sharding`` (the weights an argument), clamped as
  the port's output is, through JAX's ``run_plan``; within
  ``tests/test_parallel.py``'s 1e-4 (measured 2.9e-6; JAX's split is
  2.4e-6 from its one device there).
* S, L and G on a ``(2, 2)`` mesh at 128x128 (one pair a data shard,
  ``plan_timestep(3, 2)``, batch 2) against the port's one device: f64
  within 1e-6, f32 within 3e-5 (measured 0 and 2.4e-6 for S). The joint
  mean and the correlation lookup are f32 in every dtype, so the f64 gap
  is f32 rounding.
* An uneven split: 2 x 208x64 (a multiple of 16, as the node pads AMT's
  clips) in 128 + 80 rows, in f64 within 1e-6 (measured 6.0e-8); the
  rules AMT needed ran: IFRNet's (``Tensor.__setitem__`` 8 a forward, one
  ``torch.cat`` along the rows), ``Tensor.expand`` of the frames over the
  flows (2), and the correlation on bands: one ``BidirCorr`` hand-over,
  whose three lookups run each direction on each band (12 windowed
  lookups against each band's gathered target pyramid).
* the lookup's hand-over under a gradient (the training step on the
  axis) gives the whole tensors' gradients within 1e-5; a lookup at
  coordinates that are not row bands raises, naming ``ROADMAP.md``'s item.

One JAX compile (the sharded forward at 128x128).
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
from comfyui_frame_interpolation_tpu.models import amt as jamt
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch import parallel
from comfyui_frame_interpolation_tpu_torch.core.loop import run_plan
from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_timestep
from comfyui_frame_interpolation_tpu_torch.models import amt
from comfyui_frame_interpolation_tpu_torch.ops.bidir_corr import BidirCorr
from comfyui_frame_interpolation_tpu_torch.parallel import space
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

CPU = torch.device("cpu")
JAX_ATOL = 1e-4  # tests/test_parallel.py:132
F32_ATOL = 3e-5
F64_ATOL = 1e-6
GRAD_ATOL = 1e-5
CKPT = {"S": "amt-s.pth", "L": "amt-l.pth", "G": "amt-g.pth"}


def _replicas(n):
    return [CPU] * n


@functools.lru_cache(maxsize=None)
def _params(variant):
    return amt.init_params(variant, 0)


def _make(variant="S", dtype=torch.float32):
    return lambda d: amt.make_model_fn(_params(variant), CKPT[variant], dtype=dtype, device=d)


def _frames(h, w, seed=21):
    return np.random.default_rng(seed).random((3, h, w, 3), np.float32)


def _run(frames, make, mesh=None, mids=1, batch_size=2):
    fn = make(CPU) if mesh is None else parallel.make_sharded_model_fn(make, mesh)
    return run_plan(torch.from_numpy(frames), plan_timestep(3, mids + 1), fn, batch_size=batch_size)


def test_amt_on_a_4x2_mesh_matches_jax_sharded():
    frames = _frames(128, 128)
    jmesh = jparallel.make_mesh(8)
    batch = jparallel.frame_sharding(jmesh, (4, 128, 128, 3))
    assert batch.spec == ("data", "space", None, None)
    sharded = jax.jit(
        lambda p, a, b, t: jnp.clip(jamt.apply(p, a, b, t, variant="S", num_flows=3), 0.0, 1.0),
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


@pytest.mark.parametrize("variant", ["S", "L", "G"])
@pytest.mark.parametrize("dtype, atol", [(torch.float64, F64_ATOL), (torch.float32, F32_ATOL)], ids=["f64", "f32"])
def test_amt_on_a_2x2_mesh_matches_one_device(variant, dtype, atol):
    frames = _frames(128, 128)
    mesh = parallel.make_mesh(4, devices=_replicas(4))
    assert dict(mesh.shape) == {"data": 2, "space": 2}
    ref = _run(frames, _make(variant, dtype))
    out = _run(frames, _make(variant, dtype), mesh)
    assert out.shape == ref.shape == (5, 128, 128, 3) and out.dtype == torch.float32
    torch.testing.assert_close(out, ref, rtol=0, atol=atol)


def test_amt_on_an_uneven_split_matches_one_device(monkeypatch):
    assert space.band_rows(208, 2) == [(0, 128), (128, 80)]
    rng = np.random.default_rng(22)
    f0, f1 = (torch.from_numpy(rng.random((2, 208, 64, 3))) for _ in range(2))
    t = torch.tensor([0.3, 0.6])
    make = _make("S", torch.float64)
    ref = make(CPU)(f0, f1, t)

    ran = {"_setitem": 0, "_cat_rows": 0, "_expand": 0, "_bidir_corr_rule": 0, "windowed": 0}

    def counted(name, fn):
        def call(*a, **k):
            ran[name] += 1
            return fn(*a, **k)
        return call

    for f, rule in list(space._RULES.items()):
        if rule.__name__ in ran:
            monkeypatch.setitem(space._RULES, f, counted(rule.__name__, rule))
    monkeypatch.setattr(space, "_cat_rows", counted("_cat_rows", space._cat_rows))
    monkeypatch.setattr(BidirCorr, "windowed", counted("windowed", BidirCorr.windowed))
    out = parallel.make_sharded_model_fn(make, parallel.make_mesh(2, devices=_replicas(2)))(f0, f1, t)
    assert ran == {"_setitem": 8, "_cat_rows": 1, "_expand": 2, "_bidir_corr_rule": 1, "windowed": 12}
    assert out.shape == (2, 208, 64, 3)
    torch.testing.assert_close(out, ref, rtol=0, atol=F64_ATOL)


def test_the_lookup_on_bands_with_a_gradient_raises():
    """With a gradient (the training step on the axis) the correlation's
    hand-over runs: each band's lookup takes ``BidirCorr.windowed``'s
    out-of-place form, and the gradients of both feature maps and both
    coordinate maps are the whole tensors' within ``GRAD_ATOL`` (f32 dots
    and pools over each band's queries; measured 4.8e-7 on gradients up to
    ~6; the coordinates' bit for bit). A lookup at coordinates that are
    not NHWC row bands still raises, naming ``ROADMAP.md``'s item."""
    rng = np.random.default_rng(24)
    f0, f1 = (torch.from_numpy(rng.random((1, 4, 128, 8), np.float32)).requires_grad_() for _ in range(2))
    gy, gx = np.meshgrid(np.arange(128, dtype=np.float32), np.arange(8, dtype=np.float32), indexing="ij")
    grid = np.stack([gx, gy], -1)[None]
    c0, c1 = (torch.from_numpy(grid + rng.normal(0, 3, grid.shape).astype(np.float32)).requires_grad_() for _ in range(2))
    weights = [torch.from_numpy(rng.uniform(-1, 1, (1, 4 * 49, 128, 8)).astype(np.float32)) for _ in range(2)]

    def grads(out):
        return torch.autograd.grad(sum((w * o).sum() for w, o in zip(weights, out)), (f0, f1, c0, c1))

    ref = grads(BidirCorr(f0, f1).lookup(c0, c1))
    b0, b1 = (space.split_rows(f, _replicas(2), dim=2) for f in (f0, f1))
    cb0, cb1 = (space.split_rows(c, _replicas(2), dim=1) for c in (c0, c1))
    corr = BidirCorr(b0, b1)
    got = grads([o.gather(CPU) for o in corr.lookup(cb0, cb1)])
    for g, r in zip(got, ref):
        assert float(r.abs().max()) > 0
        torch.testing.assert_close(g, r, rtol=0, atol=GRAD_ATOL)
    with pytest.raises(NotImplementedError, match="(?s)BidirCorr.lookup at .*ROADMAP.md Queue 1 item 3"):
        corr.lookup(c0, c1)