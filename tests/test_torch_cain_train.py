"""CAIN training in the port against the JAX package's, on the CPU.

The L1 loss and the gradient of every parameter of ``pretrained_cain.pth``
(``init_params(0)``, loaded with ``strict=True``) at b1 x 128x128 f32
(CAIN reflect-pads to multiples of 128, so a smaller frame costs the same)
are held against ``jax.value_and_grad`` of the same loss through JAX
``models/cain.py:apply``, jitted, in f32, with RIFE's tolerance: the loss
within 1e-6 relative (measured 9.4e-8), each gradient within 5e-5 of its
tensor's largest magnitude plus 1e-7 (measured: median 1.0e-6, every tensor
within the 1e-7; JAX's own f32 gradients lie a median 6.3e-7 from its f64
ones). Every parameter gets a gradient.

Not at 64x64: CAIN runs on 8x pixel-unshuffled features, 16x16 positions
for a 128x128 pad, so one ReLU input that rounds to the other side of 0
moves a weight gradient by ~1/256 of its size. The 64x64 frame, padded 32
a side, meets such ties: there JAX's own f32 gradients are 8.3e-3 from its
f64 ones at worst and the port's 8.3e-3, a spread no tolerance could tell
from a fault. The port's ``apply`` takes NCHW frames; the step's ``apply_fn``
permutes the NHWC batch, as the node's model function does. No hand kernel
runs on this path: CAIN has no warp and no splat.

Then torch only: one ``parallel.make_train_step`` step on a CPU mesh gives
the loss and gradients of the plain ``loss.backward()`` and Adam's first
step. One JAX compile in this file: the ``value_and_grad``.
"""

import functools

import numpy as np
import torch

import jax.numpy as jnp

import torch_train_cases as tc
from comfyui_frame_interpolation_tpu.models import cain as jm
from comfyui_frame_interpolation_tpu_torch.models import cain as pm
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

N_TENSORS = 494
B, HW = 1, (128, 128)


@functools.lru_cache(maxsize=None)
def _params():
    return pm.init_params(0)


def _net():
    return pm._load(tc.fresh(_params()), torch.float32, "cpu")


def _port_apply(net, f0, f1, t):
    return pm.apply(net, f0.permute(0, 3, 1, 2), f1.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _jax_apply(p, dtype):
    (f0, f1), _, _ = tc.batch(B, HW)
    return jm.apply(p, jnp.asarray(f0, dtype), jnp.asarray(f1, dtype))


@functools.lru_cache(maxsize=None)
def _jax_param_grads(f64=False):
    _, _, target = tc.batch(B, HW)
    loss, jgrads = tc.jax_loss_and_grads(_params(), _jax_apply, target, f64=f64)
    return loss, tc.jax_param_grads(_net(), jgrads)


@functools.lru_cache(maxsize=None)
def _port_loss_and_grads():
    fr, t, target = tc.batch(B, HW)
    return tc.port_loss_and_grads(_net(), lambda n: _port_apply(n, *(torch.from_numpy(x) for x in (*fr, t))), target)


def test_every_parameter_is_loaded_and_trained():
    _, grads = _port_loss_and_grads()
    _, jgrads = _jax_param_grads()
    assert sorted(_net().state_dict()) == sorted(_params()) and len(grads) == N_TENSORS
    tc.assert_untrained_are_zero_in_jax(grads, jgrads, [])


def test_cain_loss_and_gradients_match_jax():
    jloss, jgrads = _jax_param_grads()
    loss, grads = _port_loss_and_grads()
    np.testing.assert_allclose(loss, jloss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, jgrads)


def test_train_step_on_a_cpu_mesh_is_the_plain_backward():
    fr, t, target = tc.batch(B, HW)
    loss, grads, deltas = tc.step_on_cpu_mesh(_net, _port_apply, fr, t, target)
    ref_loss, ref_grads = _port_loss_and_grads()
    np.testing.assert_allclose(loss, ref_loss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, ref_grads)
    tc.assert_adam_first_step(grads, deltas)


if __name__ == "__main__":
    # this file's size, then 64x64 (a 32-pixel reflect pad a side)
    for HW in ((128, 128), (64, 64)):
        _jax_param_grads.cache_clear()
        _port_loss_and_grads.cache_clear()
        jloss, j32 = _jax_param_grads()
        loss, grads = _port_loss_and_grads()
        _, j64 = _jax_param_grads(True)
        print(f"{HW}: loss {abs(loss - jloss) / abs(jloss):.3g} relative; " + tc.spread_report("port against JAX f32", grads, j32)
              + f"; {len(grads)} parameters, untrained {tc.untrained(grads)}")
        print("  " + tc.spread_report("JAX f32 against JAX f64", j32, j64) + "; " + tc.spread_report("port against JAX f64", grads, j64))
