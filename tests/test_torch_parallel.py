"""The port's ``parallel/`` against the JAX package's, on the CPU.

* ``make_mesh`` and ``frame_sharding`` as ``tests/test_parallel.py:41-55``
  holds JAX's, on 8 logical replicas of the CPU.
* ``make_sharded_model_fn`` (RIFE 4.7) through ``run_plan`` and
  ``make_sharded_pair_fns`` (M2M) through ``run_plan_pair_cached`` over a
  4-way data mesh of logical replicas, against the same executors with one
  device: within 1e-5 (each shard runs a batch of 1 where the one device runs
  4; the convolutions may pick other algorithms). On a one-device mesh the
  wrappers' split path (one shard of the whole batch) gives the model's
  own output, bit for bit.
* RIFE 4.7's L1 loss and every parameter's gradient at b2 x 64x64 f32
  against ``jax.value_and_grad`` of the same loss, with the same weights
  (the port's numpy ``init_params`` carried to JAX and back by
  ``params_from_jax``): the loss within 1e-6 relative, each gradient within
  5e-5 of its tensor's largest magnitude plus 1e-7 (the convolutions' sums
  in another order; measured 3.4e-6; a pixel where the two forwards
  straddle the target would flip the L1 loss's sign there and move a
  gradient by a share of 1/N, which these inputs do not meet).
* one ``make_train_step`` step (Adam 1e-4) against the JAX
  ``make_train_step`` with ``optax.adam(1e-4)`` on ``make_mesh(1)``: the
  same loss, and the same update wherever JAX's gradient is over 10x the
  gradient tolerance (Adam's first step is ``-lr * g / (|g| + eps)``,
  about ``-lr * sign(g)``), within 1e-3 of the learning rate plus one f32
  ulp of a parameter below 2 (1.2e-7: the weights are under 1, the ResConv
  betas start at 1).
* a 2-way data-parallel step equal to the 1-device step: the loss within
  1e-6 relative, the gradients within 5e-5 of each tensor's largest
  magnitude (measured 2.4e-6: each shard's convolutions run a batch of 1),
  the updates where the gradient is large.
* a batch that the policy splits over ``space`` (b2 x 128x128 on a ``(1,
  2)`` mesh: two bands of 64 rows) runs RIFE 4.7 through
  ``make_sharded_model_fn`` and ``make_train_step`` as one device does: the
  frames within 1e-5 (measured 0), the loss within 1e-6 relative, the
  gradients within 5e-5 of each tensor's largest magnitude, the updates
  where the gradient is large (the step also at b2 x 136x64, whose pad
  lands in the last band); ``make_sharded_pair_fns`` of GMFSS raises there
  at its first op without a row-band rule (M2M's runs:
  ``tests/test_torch_space_m2m.py``). ``tests/test_torch_space.py`` holds
  the rest of the ``space`` axis.

One JAX compile per function (the loss's ``value_and_grad`` and the train
step), at 64x64.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from comfyui_frame_interpolation_tpu import parallel as jparallel
from comfyui_frame_interpolation_tpu.models import rife as jrife
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict
from comfyui_frame_interpolation_tpu_torch import parallel
from comfyui_frame_interpolation_tpu_torch.core.loop import run_plan, run_plan_pair_cached
from comfyui_frame_interpolation_tpu_torch.core.schedule import plan_timestep
from comfyui_frame_interpolation_tpu_torch.models import m2m, rife
from comfyui_frame_interpolation_tpu_torch.parallel import train
from comfyui_frame_interpolation_tpu_torch.utils.ckpt import params_from_jax
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

CPU = torch.device("cpu")
LR = 1e-4
GRAD_RTOL, GRAD_ATOL = 5e-5, 1e-7
UPDATE_ATOL = 1e-3 * LR + 2.0**-23  # one f32 ulp of a parameter in [1, 2)
HW = 64


def _replicas(n):
    return [CPU] * n


def test_mesh_shape():
    mesh = parallel.make_mesh(8, devices=_replicas(8))
    assert dict(mesh.shape) == {"data": 4, "space": 2}
    assert dict(parallel.make_mesh(1, devices=_replicas(1)).shape) == {"data": 1, "space": 1}
    assert dict(parallel.make_mesh(3, devices=_replicas(3)).shape) == {"data": 3, "space": 1}


def test_frame_sharding_policy():
    mesh = parallel.make_mesh(8, devices=_replicas(8))
    assert parallel.frame_sharding(mesh, (4, 256, 256, 3)).spec == ("data", "space", None, None)
    # below the per-shard row floor: pure data parallelism
    assert parallel.frame_sharding(mesh, (4, 64, 64, 3)).spec == ("data", None, None, None)
    assert parallel.data_sharding(mesh).spec == ("data", "space", None, None)
    assert parallel.replicated(mesh).spec == ()
    assert parallel.MIN_ROWS_PER_SHARD == jparallel.MIN_ROWS_PER_SHARD


def test_make_mesh_needs_cuda_unless_devices_are_given(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError):
        train.dryrun(1)


def test_all_names_equal_jax():
    assert sorted(parallel.__all__) == sorted(jparallel.__all__)


def _frames(n, seed):
    return torch.from_numpy(np.random.default_rng(seed).random((n, HW, HW, 3), dtype=np.float32))


def test_sharded_rife_through_run_plan_matches_one_device():
    params = rife.init_params(3, "4.7")
    make = functools.partial(rife.make_model_fn, params, "4.7")
    frames, plan = _frames(3, 3), plan_timestep(3, 3)
    ref = run_plan(frames, plan, make(device=CPU), batch_size=4)
    one = run_plan(frames, plan, parallel.make_sharded_model_fn(lambda d: make(device=d), parallel.make_mesh(1, devices=_replicas(1))), batch_size=4)
    mesh = parallel.make_mesh(4, shape=(4, 1), devices=_replicas(4))
    out = run_plan(frames, plan, parallel.make_sharded_model_fn(lambda d: make(device=d), mesh), batch_size=4)
    assert torch.equal(one, ref)
    assert out.shape == ref.shape == (7, HW, HW, 3)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


def test_sharded_m2m_through_run_plan_pair_cached_matches_one_device():
    params = m2m.init_params(0)
    make = functools.partial(m2m.make_pair_fns, params)
    frames, plan = _frames(3, 4), plan_timestep(3, 3)
    ref = run_plan_pair_cached(frames, plan, *make(device=CPU), batch_size=4)
    one = run_plan_pair_cached(
        frames, plan, *parallel.make_sharded_pair_fns(lambda d: make(device=d), parallel.make_mesh(1, devices=_replicas(1))),
        batch_size=4,
    )
    mesh = parallel.make_mesh(4, shape=(4, 1), devices=_replicas(4))
    out = run_plan_pair_cached(frames, plan, *parallel.make_sharded_pair_fns(lambda d: make(device=d), mesh), batch_size=4)
    assert torch.equal(one, ref)
    assert out.shape == ref.shape == (7, HW, HW, 3)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


def _batch():
    rng = np.random.default_rng(9)
    f0, f1, target = (rng.random((2, HW, HW, 3), dtype=np.float32) for _ in range(3))
    t = np.asarray([0.5, 0.25], np.float32)
    return f0, f1, t, target


@functools.lru_cache(maxsize=None)
def _jax_params():
    return nest_state_dict(rife.init_params(0, "4.7"))


def _jax_apply(params, f0, f1, t):
    return jrife.apply(params, f0, f1, t, jrife.default_scale_list("4.7"), arch_ver="4.7")


def _port_net():
    net = rife.IFNet("4.7")
    net.load_state_dict(params_from_jax(_jax_params()), strict=True)
    return net.to(memory_format=torch.channels_last)


def _port_apply(net, f0, f1, t):
    return rife.apply(net, f0, f1, t, rife.default_scale_list("4.7"))


def _port_step(mesh, batch):
    net = _port_net()
    opt = torch.optim.Adam(net.parameters(), lr=LR)
    step = parallel.make_train_step(_port_apply, opt, mesh, net)
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    loss = step(*(torch.from_numpy(a) for a in batch))
    grads = {k: v.grad.clone() for k, v in net.named_parameters()}
    deltas = {k: v.detach() - before[k] for k, v in net.named_parameters()}
    return float(loss), grads, deltas


@functools.lru_cache(maxsize=None)
def _one_device_step():
    return _port_step(parallel.make_mesh(1, devices=_replicas(1)), _batch())


def _assert_grads_close(got, ref, rtol):
    assert got.keys() == ref.keys()
    for k in ref:
        scale = float(ref[k].abs().max())
        err = float((got[k] - ref[k]).abs().max())
        assert err <= rtol * scale + GRAD_ATOL, (k, err, scale)


def test_rife_loss_and_gradients_match_jax():
    f0, f1, t, target = _batch()

    def loss_fn(params, f0, f1, t, target):
        return jparallel.l1_loss(_jax_apply(params, f0, f1, t), target)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(_jax_params(), f0, f1, t, target)
    ref = params_from_jax(jgrads)
    net = _port_net()
    loss = train.l1_loss(_port_apply(net, *(torch.from_numpy(a) for a in (f0, f1, t))), torch.from_numpy(target))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    _assert_grads_close({k: v.grad for k, v in net.named_parameters()}, ref, GRAD_RTOL)


def test_train_step_matches_jax_train_step():
    f0, f1, t, target = _batch()
    jmesh = jparallel.make_mesh(1)
    optimizer = optax.adam(LR)
    jparams = jax.tree_util.tree_map(jnp.asarray, _jax_params())
    jstep = jparallel.make_train_step(_jax_apply, optimizer, jmesh)
    with jmesh:
        new_params, _, jloss = jstep(jparams, optimizer.init(jparams), f0, f1, t, target)
    jdelta = params_from_jax(jax.tree_util.tree_map(lambda a, b: a - b, new_params, jparams))
    loss, grads, deltas = _one_device_step()
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-6)
    n_big = 0
    for k, g in grads.items():
        big = g.abs() > 10 * (GRAD_RTOL * float(g.abs().max()) + GRAD_ATOL)
        n_big += int(big.sum())
        torch.testing.assert_close(deltas[k][big], jdelta[k][big], rtol=0, atol=UPDATE_ATOL)
        assert float(deltas[k].abs().max()) <= LR * (1 + 1e-3)
    assert n_big > 1000


def test_two_way_data_parallel_step_equals_one_device():
    loss1, grads1, deltas1 = _one_device_step()
    loss2, grads2, deltas2 = _port_step(parallel.make_mesh(2, shape=(2, 1), devices=_replicas(2)), _batch())
    np.testing.assert_allclose(loss2, loss1, rtol=1e-6)
    _assert_grads_close(grads2, grads1, GRAD_RTOL)
    for k, g in grads1.items():
        big = g.abs() > 10 * (GRAD_RTOL * float(g.abs().max()) + GRAD_ATOL)
        torch.testing.assert_close(deltas2[k][big], deltas1[k][big], rtol=0, atol=UPDATE_ATOL)


def test_space_todo_names_the_roadmap_item():
    """The message a run on the ``space`` axis gets names the item of
    ``ROADMAP.md``'s Queue 1 that ports the axis, by the number the file
    gives it."""
    import os
    import re

    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "ROADMAP.md")) as f:
        roadmap = f.read()
    queue = roadmap[roadmap.index("### Queue 1"):]
    queue = queue[: queue.index("\n### ", 1)]
    items = re.findall(r"^(\d+)\. \*\*(.*?)\*\*", queue, re.M)
    (number,) = [n for n, title in items if "`space` axis" in title]
    assert f"ROADMAP.md Queue 1 item {number}" in parallel.mesh.SPACE_TODO
    mesh = parallel.make_mesh(2, devices=_replicas(2))
    with pytest.raises(NotImplementedError, match=f"Queue 1 item {number};"):
        parallel.mesh.check_runnable(mesh, (2, 128, 64, 3))


def _tall_batch(hw=(2 * HW, 2 * HW)):
    rng = np.random.default_rng(10)
    f0, f1, target = (rng.random((2, *hw, 3), dtype=np.float32) for _ in range(3))
    return f0, f1, np.asarray([0.5, 0.25], np.float32), target


@pytest.mark.parametrize("entry", ["model_fn", "train_step", "train_step_padded", "pair_fns"])
def test_space_axis_raises(entry):
    """On a ``(1, 2)`` mesh, where the policy splits 128 rows into two bands:
    the model function and the train step run and match one device (the
    step also at 136x64, split 128 + 8 rows, where RIFE's pad to 192 lands
    in the last band); the pair-cached split of a pair of functions without
    the rules they need (a stand-in whose reuse takes the median of the
    stacked frames: every pair-cached family of the port runs on the axis,
    ``tests/test_torch_space_{m2m,xvfi,x4k,gmfss,eisai}.py``) still raises at
    its first op without a rule, naming the ``ROADMAP.md`` item."""
    mesh = parallel.make_mesh(2, devices=_replicas(2))  # (1, 2): the space axis
    assert dict(mesh.shape) == {"data": 1, "space": 2}
    f0, f1, t, target = (torch.from_numpy(a) for a in _tall_batch())
    assert parallel.frame_sharding(mesh, f0.shape).spec == ("data", "space", None, None)
    if entry == "model_fn":
        make = functools.partial(rife.make_model_fn, rife.init_params(0, "4.7"), "4.7")
        out = parallel.make_sharded_model_fn(lambda d: make(device=d), mesh)(f0, f1, t)
        torch.testing.assert_close(out, make(device=CPU)(f0, f1, t), rtol=0, atol=1e-5)
        # below the row floor the policy splits the batch only, which runs
        short = torch.from_numpy(np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32))
        assert parallel.make_sharded_model_fn(lambda d: make(device=d), mesh)(short, short, t).shape == (2, 64, 64, 3)
    elif entry.startswith("train_step"):
        batch = _tall_batch((136, HW)) if entry == "train_step_padded" else _tall_batch()
        loss1, grads1, deltas1 = _port_step(parallel.make_mesh(1, devices=_replicas(1)), batch)
        loss2, grads2, deltas2 = _port_step(mesh, batch)
        np.testing.assert_allclose(loss2, loss1, rtol=1e-6)
        _assert_grads_close(grads2, grads1, GRAD_RTOL)
        n_big = 0
        for k, g in grads1.items():
            big = g.abs() > 10 * (GRAD_RTOL * float(g.abs().max()) + GRAD_ATOL)
            n_big += int(big.sum())
            torch.testing.assert_close(deltas2[k][big], deltas1[k][big], rtol=0, atol=UPDATE_ATOL)
        assert n_big > 1000
    else:
        def make_pair(device):
            return (lambda a, b: torch.stack([a, b]).median(0).values), (lambda a, b, cache, tt: cache)

        reuse, _ = parallel.make_sharded_pair_fns(make_pair, mesh)
        with pytest.raises(NotImplementedError, match="Tensor.median has no row-band rule: .*ROADMAP.md Queue 1 item"):
            reuse(f0, f1)


def test_dryrun_on_cpu_replicas(capsys):
    train.dryrun(2, device="cpu")
    assert "dryrun_multichip(2) OK: loss=" in capsys.readouterr().out
