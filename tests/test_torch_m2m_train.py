"""M2M training in the port against the JAX package's, on the CPU.

The splat's gradient makes M2M the first splatting family that trains. Its
L1 loss and the gradient of every one of its 188 parameters
(``M2M.pth``'s tensors, from ``models.m2m.init_params``) at b2 x 64x64 f32
are held against ``jax.value_and_grad`` of the same loss through the JAX
package's ``models/m2m.py:apply`` (warps and splat on their XLA paths:
``warp_xla``, ``_softsplat_xla``), with the same weights carried to JAX by
``nest_state_dict`` and back by ``params_from_jax``, with RIFE's tolerance
(``tests/test_torch_parallel.py``): the loss within 1e-6 relative, each
gradient within 5e-5 of its tensor's largest magnitude plus 1e-7. The
convolutions sum in another order than XLA:CPU's; the photometric metrics
(up to ``paramAlpha`` = 10) read warps at flows that differ by ~1e-6 px.
Measured: the loss 5.2e-7 apart, the worst gradient at 22 % of its
tolerance (``netFlow.netFiv.netMain.netMain.7.weight``).

Then torch only, on logical replicas of the CPU:

* one ``parallel.make_train_step`` step (L1, Adam 1e-4) gives the loss and
  the gradients of the plain ``loss.backward()`` above (the step runs the
  same forward through ``torch.func.functional_call``) and moves every
  parameter whose gradient is not 0 by at most the learning rate (Adam's
  first step is about ``-lr * sign(g)``);
* a 2-way data-parallel step equals the one-device step: the loss within
  1e-6 relative, the gradients within 5e-5 of each tensor's largest
  magnitude plus 1e-7 (each shard's convolutions run a batch of 1), the
  updates where the gradient is over 10x that tolerance within 1e-3 of the
  learning rate plus one f32 ulp of a parameter below 16 (``paramAlpha``
  starts at 10).

The step split by rows over the ``space`` axis is
``tests/test_torch_space_train_splat.py``'s.

One JAX compile in this file: the loss's ``value_and_grad`` (~50 s on
XLA:CPU).
"""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu import parallel as jparallel
from comfyui_frame_interpolation_tpu.models import m2m as jm
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch import parallel
from comfyui_frame_interpolation_tpu_torch.models import m2m
from comfyui_frame_interpolation_tpu_torch.parallel import train
from comfyui_frame_interpolation_tpu_torch.utils.ckpt import params_from_jax
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

CPU = torch.device("cpu")
LR = 1e-4
LOSS_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 5e-5, 1e-7
UPDATE_ATOL = 1e-3 * LR + 2.0**-20  # one f32 ulp of a parameter in [8, 16)
HW = 64
N_TENSORS = 188


def _batch():
    rng = np.random.default_rng(15)
    f0, f1, target = (rng.random((2, HW, HW, 3), dtype=np.float32) for _ in range(3))
    t = np.asarray([0.5, 0.25], np.float32)
    return f0, f1, t, target


@functools.lru_cache(maxsize=None)
def _params():
    return m2m.init_params(0)


def _net():
    net = m2m.M2M_PWC()
    net.load_state_dict(_params(), strict=True)
    return net.to(memory_format=torch.channels_last)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    f0, f1, t, target = _batch()

    def loss_fn(params, f0, f1, t, target):
        return jparallel.l1_loss(jm.apply(params, f0, f1, t), target)

    jparams = to_jax_tree(nest_state_dict(_params()))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jparams, f0, f1, t, target)
    return float(loss), {k: v.float() for k, v in params_from_jax(grads).items()}


@functools.lru_cache(maxsize=None)
def _port_loss_and_grads():
    f0, f1, t, target = (torch.from_numpy(a) for a in _batch())
    net = _net()
    loss = train.l1_loss(m2m.apply(net, f0, f1, t), target)
    loss.backward()
    return float(loss.detach()), {k: v.grad.clone() for k, v in net.named_parameters()}


def _assert_grads_close(got, ref):
    assert got.keys() == ref.keys()
    for k in ref:
        scale = float(ref[k].abs().max())
        err = float((got[k] - ref[k]).abs().max())
        assert err <= GRAD_RTOL * scale + GRAD_ATOL, (k, err, scale)


def _step(mesh):
    net = _net()
    step = parallel.make_train_step(m2m.apply, torch.optim.Adam(net.parameters(), lr=LR), mesh, net)
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    loss = step(*(torch.from_numpy(a) for a in _batch()))
    grads = {k: v.grad.clone() for k, v in net.named_parameters()}
    deltas = {k: v.detach() - before[k] for k, v in net.named_parameters()}
    return float(loss), grads, deltas


@functools.lru_cache(maxsize=None)
def _one_device_step():
    return _step(parallel.make_mesh(1, devices=[CPU]))


def test_every_parameter_is_trained():
    """Every tensor gets a gradient (the splat's and the warps' reach the
    flow net, the refinement net and ``paramAlpha``) but the five PReLU
    slopes of the flow net's cost volumes: an L1 cost volume is never
    negative, so their gradient is exactly 0, in JAX too."""
    _, grads = _port_loss_and_grads()
    _, jgrads = _jax_loss_and_grads()
    assert len(grads) == N_TENSORS
    assert sorted(grads) == sorted(_params())
    untrained = sorted(k for k, g in grads.items() if not float(g.abs().max()) > 0.0)
    assert untrained == sorted(f"netFlow.net{lvl}.netCostacti.weight" for lvl in ("One", "Two", "Thr", "Fou", "Fiv"))
    assert all(float(jgrads[k].abs().max()) == 0.0 for k in untrained)
    assert float(grads["paramAlpha"].abs().max()) > 0.0


def test_m2m_loss_and_gradients_match_jax():
    jloss, jgrads = _jax_loss_and_grads()
    loss, grads = _port_loss_and_grads()
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    assert len(jgrads) == N_TENSORS
    _assert_grads_close(grads, jgrads)


def test_train_step_moves_the_parameters():
    loss, grads, deltas = _one_device_step()
    ref_loss, ref_grads = _port_loss_and_grads()
    np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)
    _assert_grads_close(grads, ref_grads)
    moved = 0
    for k, g in grads.items():
        assert float(deltas[k].abs().max()) <= LR + UPDATE_ATOL, k
        moved += int((deltas[k] != 0).sum())
        # Adam's first step: -lr * g / (|g| + 1e-8), -lr * sign(g) within
        # 1e-3 of lr where |g| > 1e-5
        big = g.abs() > max(10 * (GRAD_RTOL * float(g.abs().max()) + GRAD_ATOL), 1e-5)
        torch.testing.assert_close(deltas[k][big], -LR * torch.sign(g[big]), rtol=0, atol=1e-3 * LR + UPDATE_ATOL)
    assert moved > 0.9 * sum(g.numel() for g in grads.values())


def test_two_way_data_parallel_step_equals_one_device():
    loss1, grads1, deltas1 = _one_device_step()
    loss2, grads2, deltas2 = _step(parallel.make_mesh(2, shape=(2, 1), devices=[CPU] * 2))
    np.testing.assert_allclose(loss2, loss1, rtol=LOSS_RTOL)
    _assert_grads_close(grads2, grads1)
    for k, g in grads1.items():
        big = g.abs() > 10 * (GRAD_RTOL * float(g.abs().max()) + GRAD_ATOL)
        torch.testing.assert_close(deltas2[k][big], deltas1[k][big], rtol=0, atol=UPDATE_ATOL)
