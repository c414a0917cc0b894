"""Sepconv training in the port against the JAX package's, on the CPU.

The L1 loss and the gradient of every one of the 88 parameters of
``sepconv.pth`` (``init_params(0)`` conditioned as ``bench.py``,
``tests/test_torch_sepconv.py`` and ``chip_smoke.sepconv_conditioned``
condition it: each kernel head's last
convolution x0.05 and its bias 1/51, so that the taps sum near 1 and the
normaliser stays away from 0; loaded with ``strict=True``) at b1 x 64x64
f32 are held against ``jax.value_and_grad`` of the same loss through JAX
``models/sepconv.py:apply``, jitted, in f32, with RIFE's tolerance: the
loss within 1e-6 relative (measured 3.6e-7), each gradient within 5e-5 of
its tensor's largest magnitude plus 1e-7 (measured: median 5.3e-6, every
tensor within the 1e-7; JAX's own f32 gradients lie a median 9.2e-7 from
its f64 ones). Every parameter gets a gradient. On the weights as drawn the
taps sum near 0, and the output divides by that normaliser (or by 1 where
it is under 0.01): a gradient there measures the division's rounding, not
the port. The port's ``apply`` takes NCHW
frames; the step's ``apply_fn`` permutes the NHWC batch, as the node's model
function does. Its separable convolution is the plain
``ops/sepconv.py:sepconv_func`` (no hand kernel runs on this path),
differentiated by autograd: its banded ``addcmul_`` loop and the ``out[:,
r0:r1] = acc`` copy.

Then torch only: one ``parallel.make_train_step`` step on a CPU mesh gives
the loss and gradients of the plain ``loss.backward()`` and Adam's first
step. One JAX compile in this file: the ``value_and_grad``.
"""

import functools
import os
import sys

import numpy as np
import torch

import jax.numpy as jnp

import torch_train_cases as tc
from comfyui_frame_interpolation_tpu.models import sepconv as jm
from comfyui_frame_interpolation_tpu_torch.models import sepconv as pm
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the script at the repository's root; it imports nothing heavy)

N_TENSORS = 88
B, HW = 1, (64, 64)


@functools.lru_cache(maxsize=None)
def _params():
    return chip_smoke.sepconv_conditioned(0)


def _net():
    return pm._load(tc.fresh(_params()), torch.float32, "cpu")


def _port_apply(net, f0, f1, t):
    return pm.apply(net, f0.permute(0, 3, 1, 2), f1.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _jax_apply(p, dtype):
    (f0, f1), _, _ = tc.batch(B, HW)
    return jm.apply(p, jnp.asarray(f0, dtype), jnp.asarray(f1, dtype))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(f64=False):
    _, _, target = tc.batch(B, HW)
    return tc.jax_loss_and_grads(_params(), _jax_apply, target, f64=f64)


def _jax_param_grads(f64=False):
    loss, jgrads = _jax_loss_and_grads(f64)
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


def test_sepconv_loss_and_gradients_match_jax():
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
    jloss, j32 = _jax_param_grads(False)
    loss, port = _port_loss_and_grads()
    print(f"loss {abs(loss - jloss) / abs(jloss):.3g} relative to JAX f32; " + tc.spread_report("port against JAX f32", port, j32)
          + f"; untrained {tc.untrained(port)}")
    rp = tc.rel_errors(port, j32)
    for k in sorted(rp, key=rp.get)[-3:]:
        print(f"  {k}: {rp[k]:.3g}")
    _, ref = _jax_param_grads(True)
    print(tc.spread_report("JAX f32 against JAX f64", j32, ref))
    print(tc.spread_report("port f32 against JAX f64", port, ref))
    rj, rp = tc.rel_errors(j32, ref), tc.rel_errors(port, ref)
    for k in sorted(rp, key=rp.get)[-3:]:
        print(f"  {k}: port {rp[k]:.3g}, JAX f32 {rj[k]:.3g}")
