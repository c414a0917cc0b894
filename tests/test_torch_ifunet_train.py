"""IFUnet training in the port against the JAX package's, on the CPU.

The L1 loss and the gradient of every parameter of ``IFUNet.pth``
(``init_params(0)``: the state dict's tensors, batch-norm statistics
included, loaded with ``strict=True`` through ``_load``, which puts the
module in ``eval()``) at b1 x 64x64 f32 (IFUnet pads to multiples of 64)
are held against ``jax.value_and_grad`` of the same loss through JAX
``models/ifunet.py:apply`` (the warps on ``warp_xla``), jitted, in f32, with
RIFE's tolerance: the loss within 1e-6 relative (measured 2.2e-7), each
gradient within 5e-5 of its tensor's largest magnitude plus 1e-7 (measured:
median 1.1e-6, worst 1.8e-7 after the 1e-7).

JAX's ``batch_norm`` is the inference form: the running statistics are
constants of the tree, and ``make_train_step`` sets no mode. The port's
batch norms (``_conv_bn`` and CBAM's spatial ``bn``) are ``nn.BatchNorm2d``
modules, which in ``train()`` mode would normalise by the batch's
statistics and move the running ones. So the net trains in ``eval()``, as
``_load`` leaves it: a ``make_train_step`` step leaves every ``running_mean``,
``running_var`` and ``num_batches_tracked`` bit for bit as loaded, and the
same net in ``train()`` mode gives another loss than JAX's (the test that
shows the mode matters).

The 29 tensors that get no gradient in the port get exactly 0 in JAX
(``_untrained``): each flow block holds a mask head for each of the three
levels (``maskconvx16``, ``x8``, ``x4``) and reads only its own, so the
other two heads of each block (12 tensors), and ResynNet's ``degrad``
branch (17), which the checkpoint holds and the forward never reads. Then
torch only: one ``parallel.make_train_step`` step on a CPU mesh gives the
loss and gradients of the plain ``loss.backward()`` and Adam's first step.

The ensemble (``apply(..., ensemble=True)``: every flow block runs again on
the swapped frames and ``1 - t``, and averages the flows and masks) is held
the same way, with RIFE's tolerance, the same 29 tensors untrained. One JAX
compile per configuration in this file: the ``value_and_grad``.
"""

import functools

import numpy as np
import torch

import jax.numpy as jnp

import torch_train_cases as tc
from comfyui_frame_interpolation_tpu.models import ifunet as jm
from comfyui_frame_interpolation_tpu_torch.models import ifunet as pm
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)
from torch_train_cases import release_module_caches  # noqa: F401  (autouse: drops the caches after the module)

N_TENSORS = 512
B, HW = 1, (64, 64)
# measured: a train()-mode net's loss is 4.5e-2 from JAX's here; anything
# past 1e-3 shows the batch's statistics at work
TRAIN_MODE_LOSS_GAP = 1e-3
BN_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


@functools.lru_cache(maxsize=None)
def _params():
    return pm.init_params(0)


def _untrained():
    heads = [f"flownet.block{i}.maskconvx{lv}.{p}" for i, own in enumerate(pm._LEVELS) for lv in pm._LEVELS if lv != own
             for p in ("weight", "bias")]
    return heads + [k for k in _params() if k.startswith("refinenet.degrad.")]


def _bn_buffers(net):
    return {k: v.detach().clone() for k, v in net.named_buffers() if k.rsplit(".", 1)[-1] in BN_BUFFERS}


def _net():
    return pm._load(tc.fresh(_params()), torch.float32, "cpu")


def _port_apply(net, f0, f1, t, ensemble=False):
    return pm.apply(net, f0, f1, t, ensemble=ensemble)


def _jax_apply(ensemble):
    def run(p, dtype):
        (f0, f1), t, _ = tc.batch(B, HW)
        return jm.apply(p, jnp.asarray(f0, dtype), jnp.asarray(f1, dtype), jnp.asarray(t, dtype), ensemble=ensemble)

    return run


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(ensemble=False):
    _, _, target = tc.batch(B, HW)
    return tc.jax_loss_and_grads(_params(), _jax_apply(ensemble), target)


def _jax_param_grads(ensemble=False):
    loss, jgrads = _jax_loss_and_grads(ensemble)
    return loss, tc.jax_param_grads(_net(), jgrads)


def _port_loss(net, ensemble=False):
    fr, t, target = tc.batch(B, HW)
    return tc.port_loss_and_grads(net, lambda n: _port_apply(n, *(torch.from_numpy(x) for x in (*fr, t)), ensemble), target)


@functools.lru_cache(maxsize=None)
def _port_loss_and_grads(ensemble=False):
    return _port_loss(_net(), ensemble)


def test_every_parameter_is_loaded_and_trained():
    _, grads = _port_loss_and_grads()
    _, jgrads = _jax_param_grads()
    assert sorted(_net().state_dict()) == sorted(_params()) and len(grads) == N_TENSORS
    tc.assert_untrained_are_zero_in_jax(grads, jgrads, _untrained())


def test_ifunet_loss_and_gradients_match_jax():
    jloss, jgrads = _jax_param_grads()
    loss, grads = _port_loss_and_grads()
    np.testing.assert_allclose(loss, jloss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, jgrads)


def test_ensemble_every_parameter_is_loaded_and_trained():
    _, grads = _port_loss_and_grads(True)
    _, jgrads = _jax_param_grads(True)
    assert len(grads) == N_TENSORS
    tc.assert_untrained_are_zero_in_jax(grads, jgrads, _untrained())


def test_ensemble_loss_and_gradients_match_jax():
    jloss, jgrads = _jax_param_grads(True)
    loss, grads = _port_loss_and_grads(True)
    assert abs(loss - _port_loss_and_grads()[0]) > 1e-6 * abs(loss)  # the ensemble pass changes the prediction
    np.testing.assert_allclose(loss, jloss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, jgrads)


def test_train_step_on_a_cpu_mesh_is_the_plain_backward():
    fr, t, target = tc.batch(B, HW)
    loss, grads, deltas = tc.step_on_cpu_mesh(_net, _port_apply, fr, t, target)
    ref_loss, ref_grads = _port_loss_and_grads()
    np.testing.assert_allclose(loss, ref_loss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, ref_grads)
    tc.assert_adam_first_step(grads, deltas)


def test_train_step_keeps_the_batch_norm_statistics():
    """A ``make_train_step`` step on a net from ``_load`` (``eval()``) leaves
    every batch norm's running statistics and count bit for bit as loaded,
    as JAX's constants are."""
    nets = []

    def make_net():
        nets.append(_net())
        return nets[-1]

    loaded = _bn_buffers(_net())
    assert len(loaded) == 3 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in _net().modules()) > 0
    fr, t, target = tc.batch(B, HW)
    tc.step_on_cpu_mesh(make_net, _port_apply, fr, t, target)
    after = _bn_buffers(nets[0])
    assert not nets[0].training and after.keys() == loaded.keys()
    assert all(torch.equal(after[k], v) for k, v in loaded.items()), [k for k, v in loaded.items() if not torch.equal(after[k], v)]


def test_train_mode_batch_norm_departs_from_jax():
    """The same net in ``train()`` mode normalises by the batch's statistics
    and moves the running ones: its loss is not JAX's, which is why the step
    trains in ``eval()``."""
    net = _net().train()
    loaded = _bn_buffers(net)
    loss, _ = _port_loss(net)
    jloss, _ = _jax_loss_and_grads()
    assert abs(loss - jloss) / abs(jloss) > TRAIN_MODE_LOSS_GAP
    moved = _bn_buffers(net)
    assert any(not torch.equal(moved[k], v) for k, v in loaded.items() if k.endswith("running_mean"))


if __name__ == "__main__":
    jloss, jgrads = _jax_param_grads()
    loss, grads = _port_loss_and_grads()
    print(f"loss {abs(loss - jloss) / abs(jloss):.3g} relative; " + tc.spread_report("port against JAX", grads, jgrads))
    none = tc.untrained(grads)
    print(len(grads), "parameters,", len(none), "untrained:", none)
    print("nonzero in JAX:", [k for k in none if float(jgrads[k].abs().max()) != 0.0])
    tl, _ = _port_loss(_net().train())
    print(f"train() mode: loss {abs(tl - jloss) / abs(jloss):.3g} relative to JAX's")
    jloss, jgrads = _jax_param_grads(True)
    loss, grads = _port_loss_and_grads(True)
    print(f"ensemble: loss {abs(loss - jloss) / abs(jloss):.3g} relative; " + tc.spread_report("port against JAX", grads, jgrads)
          + f"; untrained {len(tc.untrained(grads))}")
