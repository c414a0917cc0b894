"""FLAVR 2x training in the port against the JAX package's, on the CPU.

The L1 loss of the first (2x) output and the gradient of every parameter of
``FLAVR_2x.pth`` (``init_params(0)``, loaded with ``strict=True``) on a clip
of four frames at b1 x 64x64 f32 (FLAVR takes multiples of 16) are held
against ``jax.value_and_grad`` of the same loss through JAX
``models/flavr.py:apply`` (an NDHWC clip; the port's ``apply`` takes it
NCDHW), jitted, in f32, with RIFE's tolerance: the loss within 1e-6
relative, each gradient within 5e-5 of its tensor's largest magnitude plus
1e-7. Measured: the loss 3.6e-7 relative, the gradients a median 1.8e-6,
every tensor within the 1e-7. Every parameter gets a gradient. No hand kernel runs on this path: FLAVR has no warp and no splat.

Neither JAX's ``make_train_step`` nor the port's carries four frames, so the
step here is the same L1 through ``loss.backward()`` and one Adam step, as
STMFNet's; the gradients held against JAX are that step's. One JAX compile
in this file: the ``value_and_grad``.
"""

import functools

import numpy as np
import torch

import jax.numpy as jnp

import torch_train_cases as tc
from comfyui_frame_interpolation_tpu.models import flavr as jm
from comfyui_frame_interpolation_tpu_torch.models import flavr as pm
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

N_TENSORS = 59
B, HW = 1, (64, 64)


@functools.lru_cache(maxsize=None)
def _params():
    return pm.init_params(0)


def _net():
    return pm._load(tc.fresh(_params()), torch.float32, "cpu")


def _jax_apply(p, dtype):
    fr, _, _ = tc.batch(B, HW, frames=4)
    return jm.apply(p, jnp.stack([jnp.asarray(f, dtype) for f in fr], 1))[0]


@functools.lru_cache(maxsize=None)
def _jax_param_grads():
    _, _, target = tc.batch(B, HW, frames=4)
    loss, jgrads = tc.jax_loss_and_grads(_params(), _jax_apply, target)
    return loss, tc.jax_param_grads(_net(), jgrads)


def _port_loss(net):
    fr, _, target = tc.batch(B, HW, frames=4)
    clip = torch.stack([torch.from_numpy(f) for f in fr], 1).permute(0, 4, 1, 2, 3)
    return tc.train.l1_loss(pm.apply(net, clip)[0].permute(0, 2, 3, 1), torch.from_numpy(target))


@functools.lru_cache(maxsize=None)
def _port_step():
    """The L1 loss through ``loss.backward()`` and one Adam step: ``(loss,
    grads, updates)``."""
    net = _net()
    opt = torch.optim.Adam(net.parameters(), lr=tc.LR)
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    opt.zero_grad(set_to_none=True)
    loss = _port_loss(net)
    loss.backward()
    grads = {k: (v.grad.clone() if v.grad is not None else torch.zeros_like(v)) for k, v in net.named_parameters()}
    opt.step()
    return float(loss.detach()), grads, {k: v.detach() - before[k] for k, v in net.named_parameters()}


def test_every_parameter_is_loaded_and_trained():
    _, grads, _ = _port_step()
    _, jgrads = _jax_param_grads()
    assert sorted(_net().state_dict()) == sorted(_params()) and len(grads) == N_TENSORS
    tc.assert_untrained_are_zero_in_jax(grads, jgrads, [])


def test_flavr_loss_and_gradients_match_jax():
    jloss, jgrads = _jax_param_grads()
    loss, grads, _ = _port_step()
    np.testing.assert_allclose(loss, jloss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, jgrads)


def test_adam_step_moves_the_parameters():
    _, grads, deltas = _port_step()
    tc.assert_adam_first_step(grads, deltas)


if __name__ == "__main__":
    jloss, jgrads = _jax_param_grads()
    loss, grads, _ = _port_step()
    print(f"loss {abs(loss - jloss) / abs(jloss):.3g} relative; " + tc.spread_report("port against JAX", grads, jgrads)
          + f"; {len(grads)} parameters, untrained {tc.untrained(grads)}")
