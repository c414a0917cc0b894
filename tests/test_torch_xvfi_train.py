"""XVFI Vimeo training in the port against the JAX package's, on the CPU.

The L1 loss and the gradient of every parameter of
``XVFInet_Vimeo_exp1_latest.pt`` (``init_params``: its 72 state-dict tensors,
loaded with ``strict=True``, 68 parameters: ``channel_converter`` and
``rec_ext_ds`` are also held as ``rec_ext_ds_module.0.0`` and
``rec_ext_ds_module.1``, the reference's aliases) at b2 x 64x64 f32
(``S_tst`` 1, scale 2: XVFI divides by ``2**S_tst * scale * 4`` = 16) are
held against ``jax.value_and_grad`` of the same loss through JAX
``models/xvfi.py:apply`` (the backward warps on ``warp_xla``, the CFR
splats on ``_softsplat_xla``) in f64, with RIFE's tolerance: the loss
within 1e-6 relative, each gradient within 5e-5 of its tensor's largest
magnitude plus 1e-7. In f64 because JAX's own f32 gradients are not within
that tolerance of its f64 ones on one tensor (``vfinet.conv_flow3.0.bias``,
2.37e-4 of its largest magnitude after 1e-7 absolute; median 5.2e-7), where
the port's are within 1e-7 absolute on every tensor (median 4.7e-7; the loss
1.9e-8 relative). JAX reads the aliased tensors under ``rec_ext_ds_module``
alone, so each of the port's shared parameters is held against the sum of
JAX's gradients over its names.

The four ``vfinet.refine_unet`` conv1/conv2 tensors get no gradient in the
port, and exactly 0 in JAX: the inference path (``S_tst`` = 1) never reads
them. Then torch only: one ``parallel.make_train_step`` step on a CPU mesh
gives the loss and gradients of the plain ``loss.backward()`` and Adam's
first step. One JAX compile in this file: the f64 ``value_and_grad``.
"""

import functools

import numpy as np
import torch

import jax.numpy as jnp

import torch_train_cases as tc
from comfyui_frame_interpolation_tpu.models import xvfi as jm
from comfyui_frame_interpolation_tpu_torch.models import xvfi as pm
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

CKPT = "XVFInet_Vimeo_exp1_latest.pt"
SCALE, S_TST = 2, 1
N_STATE, N_TENSORS = 72, 68
B, HW = 2, (64, 64)
UNTRAINED = [f"vfinet.refine_unet.{m}.{p}" for m in ("conv1", "conv2") for p in ("weight", "bias")]


@functools.lru_cache(maxsize=None)
def _params():
    return pm.init_params(CKPT, 0)


def _net():
    return pm._load(tc.fresh(_params()), SCALE, torch.float32, "cpu")


def _port_apply(net, f0, f1, t):
    return pm.apply(net, f0, f1, t, S_TST)


def _jax_apply(p, dtype):
    (f0, f1), t, _ = tc.batch(B, HW)
    return jm.apply(p, jnp.asarray(f0, dtype), jnp.asarray(f1, dtype), jnp.asarray(t), module_scale_factor=SCALE, s_tst=S_TST)


@functools.lru_cache(maxsize=None)
def _jax_param_grads():
    _, _, target = tc.batch(B, HW)
    loss, jgrads = tc.jax_loss_and_grads(_params(), _jax_apply, target, f64=True)
    return loss, tc.jax_param_grads(_net(), jgrads)


@functools.lru_cache(maxsize=None)
def _port_loss_and_grads():
    fr, t, target = tc.batch(B, HW)
    return tc.port_loss_and_grads(_net(), lambda n: _port_apply(n, *(torch.from_numpy(x) for x in (*fr, t))), target)


def test_every_parameter_is_loaded_and_trained():
    _, grads = _port_loss_and_grads()
    _, jgrads = _jax_param_grads()
    assert sorted(_net().state_dict()) == sorted(_params()) and len(_params()) == N_STATE and len(grads) == N_TENSORS
    assert tc.aliases(_net())["rec_ext_ds.weight"] == ["rec_ext_ds.weight", "rec_ext_ds_module.1.weight"]
    tc.assert_untrained_are_zero_in_jax(grads, jgrads, UNTRAINED)


def test_xvfi_loss_and_gradients_match_jax():
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
    jloss, jgrads = _jax_param_grads()
    loss, grads = _port_loss_and_grads()
    print(f"loss {abs(loss - jloss) / abs(jloss):.3g} relative; " + tc.spread_report("port against JAX", grads, jgrads))
