"""FLAVR 2x, 4x and 8x training in the port against the JAX package's, on the CPU.

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
STMFNet's; the gradients held against JAX are that step's.

FLAVR 4x and 8x (``FLAVR_4x.pth``, ``FLAVR_8x.pth``: ``init_params(0,
n_outputs)`` with 3 and 7 outputs, the head's last convolution 9 and 21
channels wide) are held the same way on the L1 loss of all their outputs
against one target each (the mean over the stacked outputs), with RIFE's
tolerance. One JAX compile per head in this file: the ``value_and_grad``.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_train_cases as tc
from comfyui_frame_interpolation_tpu.models import flavr as jm
from comfyui_frame_interpolation_tpu_torch.models import flavr as pm
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)
from torch_train_cases import release_module_caches  # noqa: F401  (autouse: drops the caches after the module)

N_TENSORS = 59
B, HW = 1, (64, 64)


# FLAVR 4x and 8x: the head's outputs
MULTI = {"4x": 3, "8x": 7}


@functools.lru_cache(maxsize=None)
def _params(n_outputs=1):
    return pm.init_params(0, n_outputs)


def _net(n_outputs=1):
    return pm._load(tc.fresh(_params(n_outputs)), torch.float32, "cpu")


def _multi_batch(n_outputs):
    """Four frames and one target per output, f32 numpy: ``(frames,
    targets [B, n_outputs, H, W, 3])``."""
    fr, _, target = tc.batch(B, HW, frames=4 + n_outputs - 1)
    return fr[:4], np.stack([*fr[4:], target], 1)


def _jax_apply_multi(n_outputs):
    def run(p, dtype):
        fr, _ = _multi_batch(n_outputs)
        return jnp.stack(jm.apply(p, jnp.stack([jnp.asarray(f, dtype) for f in fr], 1), n_outputs), 1)

    return run


@functools.lru_cache(maxsize=None)
def _jax_multi_grads(n_outputs):
    _, targets = _multi_batch(n_outputs)
    loss, jgrads = tc.jax_loss_and_grads(_params(n_outputs), _jax_apply_multi(n_outputs), targets)
    return loss, tc.jax_param_grads(_net(n_outputs), jgrads)


@functools.lru_cache(maxsize=None)
def _port_multi_grads(n_outputs):
    fr, targets = _multi_batch(n_outputs)
    clip = torch.stack([torch.from_numpy(f) for f in fr], 1).permute(0, 4, 1, 2, 3)
    return tc.port_loss_and_grads(_net(n_outputs), lambda n: torch.stack(pm.apply(n, clip), 1).permute(0, 1, 3, 4, 2), targets)


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


@pytest.mark.parametrize("head", MULTI)
def test_flavr_multi_every_parameter_is_loaded_and_trained(head):
    n_outputs = MULTI[head]
    _, grads = _port_multi_grads(n_outputs)
    _, jgrads = _jax_multi_grads(n_outputs)
    assert sorted(_net(n_outputs).state_dict()) == sorted(_params(n_outputs)) and len(grads) == N_TENSORS
    assert len(pm.apply(_net(n_outputs), torch.zeros(1, 3, 4, 16, 16))) == n_outputs
    tc.assert_untrained_are_zero_in_jax(grads, jgrads, [])


@pytest.mark.parametrize("head", MULTI)
def test_flavr_multi_loss_and_gradients_match_jax(head):
    jloss, jgrads = _jax_multi_grads(MULTI[head])
    loss, grads = _port_multi_grads(MULTI[head])
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
    for head, n_outputs in MULTI.items():
        jloss, jgrads = _jax_multi_grads(n_outputs)
        loss, grads = _port_multi_grads(n_outputs)
        print(f"{head}: loss {abs(loss - jloss) / abs(jloss):.3g} relative; " + tc.spread_report("port against JAX", grads, jgrads)
              + f"; untrained {tc.untrained(grads)}")
