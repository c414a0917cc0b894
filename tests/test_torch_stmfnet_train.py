"""STMFNet training in the port against the JAX package's, on the CPU.

The L1 loss and the gradient of every one of STMFNet's 730 parameters
(``init_params(0)``: the state dict's 1,000 tensors, batch-norm statistics
included, loaded with ``strict=True``) at b1 x 128x128 f32 (STMFNet
reflect-pads to multiples of 128) on four frames are held against
``jax.value_and_grad`` of the same loss through JAX
``models/stmfnet.py:apply`` (the backwarps on ``warp_xla``, the softmax
splat on ``_softsplat_xla``, the correlation and AdaCoF on XLA), jitted, in
f32, over the tree's floating leaves (its ``num_batches_tracked`` leaves
are integers). RIFE's tolerance cannot hold one tensor, where JAX's own
f32 gradient is as far from its f64 one: the bound is taken from that
spread. On this batch, against JAX f64, JAX's jitted f32 gradients have a
median relative error of 3.51e-5 and a worst of 1.68e-4 (each tensor's
largest error over its largest magnitude; the worst after 1e-7 absolute, at
``dyntex_generator.decoder.4.upconv.0.weight``, a weight gradient that sums
terms which cancel). The port's gradient of that tensor moves with torch's
thread count by as much: against JAX f32 its worst is 1.08e-5 with 8
threads and 1.68e-4 with 2 (tier-1's per worker); the median 3.7e-6. So the
port is held within 2x JAX's own f32 spread of JAX f32: each gradient
within 3.4e-4 of its tensor's largest magnitude plus 1e-7, the median
within 7e-5; the loss within 1e-6 relative (measured 1.4e-7).
``PYTHONPATH=.:tests python tests/test_torch_stmfnet_train.py`` measures
these again (the f64 compile takes ~2 min).

The tensors that get no gradient in the port get exactly 0 in JAX:
``UNTRAINED``: every tensor of the GridNet's laterals ``0_2`` and ``0_3``
and upsamplers ``0_0`` and ``0_1``, whose outputs reach no output that the
prediction reads, and the first PReLU slopes of laterals ``0_0`` and
``1_0``, behind inputs that are never negative here.

Neither JAX's ``make_train_step`` nor the port's carries four frames, so the
step here is the same L1 through ``loss.backward()`` and one Adam step; the
gradients held against JAX are that step's.

A trap of this CPU, not of the port: oneDNN's weight gradient of a 1x1,
stride-2 convolution with 6 input channels on a ``channels_last`` input
(the skip convolutions of the feature extractor's first MS-ResNeXt block,
``feature_extractor.conv1.resnext_*.downsample.0``, ``Conv2d(6, 32, 1, 2)``
on the two mean-subtracted frames at 128x128) corrupts the heap in ``torch
2.13.0+cpu``: the process aborts (``corrupted size vs. prev_size``,
``free(): invalid next size``) or segfaults, with 1, 4 or 8 threads; not
with 3 or 8 input channels, stride 1, contiguous input, or oneDNN off.
``channels_last`` is the port's own layout (``stmfnet._nchw`` and
``common.channels_last_params``), which the card runs through cuDNN. So the
port's forward and backward run here under
``torch.backends.mkldnn.flags(enabled=False)`` (this file's ``_no_onednn``),
a setting of the test alone. One JAX compile in this file: the jitted
``value_and_grad``.
"""

import functools

import numpy as np
import torch

import jax.numpy as jnp

import torch_train_cases as tc
from comfyui_frame_interpolation_tpu.models import stmfnet as jm
from comfyui_frame_interpolation_tpu_torch.models import stmfnet as pm
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

N_STATE, N_TENSORS = 1000, 730
B, HW = 1, (128, 128)
GRAD_RTOL, MEDIAN_RTOL = 3.4e-4, 7e-5
UNTRAINED = (
    ["scale_synthesis.lateral_0_0.f.0.weight", "scale_synthesis.lateral_1_0.f.0.weight"]
    + [f"scale_synthesis.lateral_0_{i}.f.{p}" for i in (2, 3) for p in ("0.weight", "1.weight", "1.bias", "2.weight", "3.weight", "3.bias")]
    + [f"scale_synthesis.up_0_{i}.f.{p}" for i in (0, 1) for p in ("1.weight", "2.weight", "2.bias", "3.weight", "4.weight", "4.bias")]
)


def _no_onednn():
    """oneDNN off: its channels_last 1x1 stride-2 weight gradient at 6 input
    channels corrupts the heap on this CPU (the module docstring)."""
    return torch.backends.mkldnn.flags(enabled=False)


@functools.lru_cache(maxsize=None)
def _params():
    return pm.init_params(0)


def _net():
    return pm._load(tc.fresh(_params()), torch.float32, "cpu")


def _jax_apply(p, dtype):
    fr, _, _ = tc.batch(B, HW, frames=4)
    return jm.apply(p, *(jnp.asarray(f, dtype) for f in fr))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(f64=False):
    _, _, target = tc.batch(B, HW, frames=4)
    return tc.jax_loss_and_grads(_params(), _jax_apply, target, f64=f64)


def _jax_param_grads(f64=False):
    loss, jgrads = _jax_loss_and_grads(f64)
    return loss, tc.jax_param_grads(_net(), jgrads)


def _port_loss(net):
    fr, _, target = tc.batch(B, HW, frames=4)
    pred = pm.apply(net, *(pm._nchw(torch.from_numpy(f)) for f in fr)).permute(0, 2, 3, 1)
    return tc.train.l1_loss(pred, torch.from_numpy(target))


@functools.lru_cache(maxsize=None)
def _port_step():
    """The L1 loss through ``loss.backward()`` and one Adam step: ``(loss,
    grads, updates)``."""
    net = _net()
    opt = torch.optim.Adam(net.parameters(), lr=tc.LR)
    before = {k: v.detach().clone() for k, v in net.named_parameters()}
    opt.zero_grad(set_to_none=True)
    with _no_onednn():
        loss = _port_loss(net)
        loss.backward()
    grads = {k: (v.grad.clone() if v.grad is not None else torch.zeros_like(v)) for k, v in net.named_parameters()}
    opt.step()
    return float(loss.detach()), grads, {k: v.detach() - before[k] for k, v in net.named_parameters()}


def _port_loss_and_grads():
    return _port_step()[:2]


def test_every_parameter_is_loaded_and_trained():
    _, grads = _port_loss_and_grads()
    _, jgrads = _jax_param_grads()
    assert sorted(_net().state_dict()) == sorted(_params()) and len(_params()) == N_STATE and len(grads) == N_TENSORS
    tc.assert_untrained_are_zero_in_jax(grads, jgrads, UNTRAINED)


def test_stmfnet_loss_and_gradients_match_jax():
    jloss, jgrads = _jax_param_grads()
    loss, grads = _port_loss_and_grads()
    np.testing.assert_allclose(loss, jloss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, jgrads, GRAD_RTOL)
    assert tc.median_rel(grads, jgrads) <= MEDIAN_RTOL


def test_adam_step_moves_the_parameters():
    _, grads, deltas = _port_step()
    tc.assert_adam_first_step(grads, deltas)


if __name__ == "__main__":
    # JAX's own spread: its jitted f32 gradients against its f64 ones, beside the port's
    _, j32 = _jax_param_grads(False)
    _, ref = _jax_param_grads(True)
    loss, port = _port_loss_and_grads()
    print(tc.spread_report("JAX f32 against JAX f64", j32, ref))
    print(tc.spread_report("port f32 against JAX f64", port, ref))
    print(tc.spread_report("port f32 against JAX f32", port, j32))
    rj = tc.rel_errors(j32, ref)
    print("JAX f32's worst:", max(rj, key=rj.get))
    print(f"loss {abs(loss - _jax_loss_and_grads(False)[0]) / abs(_jax_loss_and_grads(False)[0]):.3g} relative to JAX f32")
    print("untrained:", tc.untrained(port))
