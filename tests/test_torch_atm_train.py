"""ATM training in the port against the JAX package's, on the CPU.

ATM base and lite, global motion on, no ensemble: the L1 loss and the
gradient of every one of the 232 parameters of each (``init_params(variant,
0)``: the state dict's 236 tensors, the four ``relative_coord`` buffers
among them, loaded with ``strict=True``) at b1 x 64x64 f32 (ATM takes
multiples of 64) are held against ``jax.value_and_grad`` of the same loss
through JAX ``models/atm.py:apply`` (the zeros-mode warps on ``warp_xla``),
jitted, in f32, with RIFE's tolerance: the loss within 1e-6 relative, each
gradient within 5e-5 of its tensor's largest magnitude plus 1e-7. Measured:
base's loss 3.3e-7 relative, gradients median 3.3e-6, worst 2.4e-6 after
the 1e-7; lite's 1.1e-7, median 1.4e-6, every tensor within the 1e-7.
Every parameter gets a gradient. JAX differentiates the ``relative_coord``
buffers too (floating leaves of its tree); the module holds them as
buffers, so they are not compared. The timestep is ignored by both: ATM
makes the midpoint.

Then torch only: one ``parallel.make_train_step`` step on a CPU mesh gives
the loss and gradients of the plain ``loss.backward()`` and Adam's first
step. One JAX compile per variant in this file: the ``value_and_grad``.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_train_cases as tc
from comfyui_frame_interpolation_tpu.models import atm as jm
from comfyui_frame_interpolation_tpu_torch.models import atm as pm
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

N_STATE, N_TENSORS = 236, 232
B, HW = 1, (64, 64)
VARIANTS = ("base", "lite")


@functools.lru_cache(maxsize=None)
def _params(variant):
    return pm.init_params(variant, 0)


def _net(variant):
    return pm._load(tc.fresh(_params(variant)), variant, torch.float32, "cpu")


def _port_apply(net, f0, f1, t):
    return pm.apply(net, f0, f1, global_motion=True, ensemble_global_motion=False)


def _jax_apply(variant):
    def run(p, dtype):
        (f0, f1), _, _ = tc.batch(B, HW)
        return jm.apply(p, jnp.asarray(f0, dtype), jnp.asarray(f1, dtype), None, variant=variant, global_motion=True,
                        ensemble_global_motion=False)

    return run


@functools.lru_cache(maxsize=None)
def _jax_param_grads(variant):
    _, _, target = tc.batch(B, HW)
    loss, jgrads = tc.jax_loss_and_grads(_params(variant), _jax_apply(variant), target)
    return loss, tc.jax_param_grads(_net(variant), jgrads)


@functools.lru_cache(maxsize=None)
def _port_loss_and_grads(variant):
    fr, t, target = tc.batch(B, HW)
    return tc.port_loss_and_grads(_net(variant), lambda n: _port_apply(n, *(torch.from_numpy(x) for x in (*fr, t))), target)


@pytest.mark.parametrize("variant", VARIANTS)
def test_every_parameter_is_loaded_and_trained(variant):
    _, grads = _port_loss_and_grads(variant)
    _, jgrads = _jax_param_grads(variant)
    assert sorted(_net(variant).state_dict()) == sorted(_params(variant)) and len(_params(variant)) == N_STATE
    assert len(grads) == N_TENSORS
    tc.assert_untrained_are_zero_in_jax(grads, jgrads, [])


@pytest.mark.parametrize("variant", VARIANTS)
def test_atm_loss_and_gradients_match_jax(variant):
    jloss, jgrads = _jax_param_grads(variant)
    loss, grads = _port_loss_and_grads(variant)
    np.testing.assert_allclose(loss, jloss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, jgrads)


@pytest.mark.parametrize("variant", VARIANTS)
def test_train_step_on_a_cpu_mesh_is_the_plain_backward(variant):
    fr, t, target = tc.batch(B, HW)
    loss, grads, deltas = tc.step_on_cpu_mesh(lambda: _net(variant), _port_apply, fr, t, target)
    ref_loss, ref_grads = _port_loss_and_grads(variant)
    np.testing.assert_allclose(loss, ref_loss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, ref_grads)
    tc.assert_adam_first_step(grads, deltas)


if __name__ == "__main__":
    for variant in VARIANTS:
        jloss, jgrads = _jax_param_grads(variant)
        loss, grads = _port_loss_and_grads(variant)
        print(f"{variant}: loss {abs(loss - jloss) / abs(jloss):.3g} relative; " + tc.spread_report("port against JAX", grads, jgrads)
              + f"; untrained {tc.untrained(grads)}")
