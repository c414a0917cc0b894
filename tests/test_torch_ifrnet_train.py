"""IFRNet S and L training in the port against the JAX package's, on the CPU.

The L1 loss and the gradient of every one of the 104 parameters of
``IFRNet_S_Vimeo90K.pth`` (``init_params("S", 0)``, loaded with
``strict=True``), and of the 104 of ``IFRNet_L_Vimeo90K.pth`` (L: the same
layers at widths 64-160 against S's 24-96; its decoders' feature warps at
C = 64-192 take the wide kernel on the card), at b2 x 64x64 f32 (IFRNet pads to multiples of 64) are held
against ``jax.value_and_grad`` of the same loss through JAX
``models/ifrnet.py:apply`` (the warps on ``warp_xla``), with RIFE's
tolerance: the loss within 1e-6 relative, each gradient within 5e-5 of its
tensor's largest magnitude plus 1e-7. Every parameter gets a gradient. The
decoders' ``ResBlock`` writes its side channels out of place under a
gradient (``models/ifrnet.py:ResBlock.forward``); before, the backward
raised.

Then torch only: one ``parallel.make_train_step`` step on a CPU mesh gives
the loss and gradients of the plain ``loss.backward()`` and Adam's first
step. One JAX compile per variant in this file: the ``value_and_grad``.
"""

import functools

import numpy as np
import torch

import jax.numpy as jnp

import torch_train_cases as tc
from comfyui_frame_interpolation_tpu.models import ifrnet as jm
from comfyui_frame_interpolation_tpu_torch.models import ifrnet as pm
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)
from torch_train_cases import release_module_caches  # noqa: F401  (autouse: drops the caches after the module)

N_TENSORS = 104
B, HW = 2, (64, 64)


@functools.lru_cache(maxsize=None)
def _params(variant="S"):
    return pm.init_params(variant, 0)


def _net(variant="S"):
    net = pm.IFRNet(variant)
    net.load_state_dict(_params(variant), strict=True)
    return net.to(memory_format=torch.channels_last)


def _port_apply(net, f0, f1, t):
    return pm.apply(net, f0, f1, t)


def _jax_apply(variant):
    def run(p, dtype):
        (f0, f1), t, _ = tc.batch(B, HW)
        return jm.apply(p, jnp.asarray(f0, dtype), jnp.asarray(f1, dtype), jnp.asarray(t, dtype), variant=variant)

    return run


@functools.lru_cache(maxsize=None)
def _jax_param_grads(variant="S"):
    _, _, target = tc.batch(B, HW)
    loss, jgrads = tc.jax_loss_and_grads(_params(variant), _jax_apply(variant), target)
    return loss, tc.jax_param_grads(_net(variant), jgrads)


@functools.lru_cache(maxsize=None)
def _port_loss_and_grads(variant="S"):
    fr, t, target = tc.batch(B, HW)
    return tc.port_loss_and_grads(_net(variant), lambda n: _port_apply(n, *(torch.from_numpy(x) for x in (*fr, t))), target)


def test_every_parameter_is_loaded_and_trained():
    _, grads = _port_loss_and_grads()
    _, jgrads = _jax_param_grads()
    assert sorted(grads) == sorted(_params()) and len(grads) == N_TENSORS
    tc.assert_untrained_are_zero_in_jax(grads, jgrads, [])


def test_ifrnet_loss_and_gradients_match_jax():
    jloss, jgrads = _jax_param_grads()
    loss, grads = _port_loss_and_grads()
    np.testing.assert_allclose(loss, jloss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, jgrads)


def test_ifrnet_l_every_parameter_is_loaded_and_trained():
    _, grads = _port_loss_and_grads("L")
    _, jgrads = _jax_param_grads("L")
    assert sorted(grads) == sorted(_params("L")) and len(grads) == N_TENSORS
    assert grads.keys() == _port_loss_and_grads()[1].keys()
    assert any(grads[k].shape != v.shape for k, v in _port_loss_and_grads()[1].items())
    tc.assert_untrained_are_zero_in_jax(grads, jgrads, [])


def test_ifrnet_l_loss_and_gradients_match_jax():
    jloss, jgrads = _jax_param_grads("L")
    loss, grads = _port_loss_and_grads("L")
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
    for variant in ("S", "L"):
        jloss, jgrads = _jax_param_grads(variant)
        loss, grads = _port_loss_and_grads(variant)
        print(f"{variant}: loss {abs(loss - jloss) / abs(jloss):.3g} relative; " + tc.spread_report("port against JAX", grads, jgrads))
