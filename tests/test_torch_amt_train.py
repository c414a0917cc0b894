"""AMT S, L and G training in the port against the JAX package's, on the CPU.

The L1 loss and the gradient of every one of the 213 parameters of
``amt-s.pth`` (``init_params("S", 0)``, loaded with ``strict=True``; 3
flows), and of every parameter of ``amt-l.pth`` and ``amt-g.pth`` (L and G:
5 flows, features of C = 48-128 and 84-128, G with more blocks; their
feature warps take the wide kernel on the card), at b2 x 64x64 f32 (AMT takes multiples of 16) are held against
``jax.value_and_grad`` of the same loss through JAX ``models/amt.py:apply``
(the warps on ``warp_xla``, the correlation lookup on ``_BidirCorr``), with
RIFE's tolerance: the loss within 1e-6 relative, each gradient within 5e-5
of its tensor's largest magnitude plus 1e-7. Every parameter gets a
gradient. The lookup's bands (``ops/bidir_corr.py:BidirCorr.windowed``) and
the decoders' ``ResBlock`` (IFRNet's) take their out-of-place forms under a
gradient; before, the backward raised.

Then torch only: one ``parallel.make_train_step`` step on a CPU mesh gives
the loss and gradients of the plain ``loss.backward()`` and Adam's first
step.

L and G are held with the loss at RIFE's 1e-6 and each gradient within
RIFE's 5e-5 of its tensor's largest plus 1e-7, but for the tensors named in
``LG_SPREAD``, each held within twice its measured spread. Those gradients
sum over every pixel and nearly cancel, so their f32 rounding moves them by
up to 2e-3 of their size: ``LG_SPREAD`` gives, per tensor, the port's
largest distance from JAX's jitted f32 over torch's 1, 2, 4 and 8 threads,
which is also the port's own spread over those thread counts for all but
G's ``update2_high.conv.weight`` and ``update2_high.flow_head.0.bias``
(JAX's own rounding; G's ``update2_high.feat_head.0.bias`` also lies
1.97e-3 between JAX's jitted and eager f32, and JAX's f64 does not run:
its lookup's indices meet int64 under x64). Every other tensor lies within
2.1e-5 of JAX's at every thread count (2.8e-5 between the port's own runs). One JAX compile per variant in this
file: the ``value_and_grad``.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_train_cases as tc
from comfyui_frame_interpolation_tpu.models import amt as jm
from comfyui_frame_interpolation_tpu_torch.models import amt as pm
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)
from torch_train_cases import release_module_caches  # noqa: F401  (autouse: drops the caches after the module)

N_TENSORS = 213
B, HW = 2, (64, 64)


NUM_FLOWS = {"S": 3, "L": 5, "G": 5}
# per variant, the tensors past 5e-5: the port's largest distance from JAX's
# jitted f32 over 1, 2, 4 and 8 torch threads (the docstring says more)
LG_SPREAD = {
    "L": {"update2.feat_head.0.bias": 1.26e-3, "decoder1.convblock.1.conv5.bias": 9.44e-5},
    "G": {"update2_high.feat_head.0.bias": 1.97e-3, "update2_high.feat_head.0.weight": 1.52e-3,
          "decoder1.convblock.0.0.weight": 1.35e-3, "decoder1.convblock.0.0.bias": 1.15e-3,
          "update2_low.feat_head.2.bias": 2.34e-4, "update2_high.feat_head.2.bias": 2.13e-4,
          "encoder.pyramid1.1.0.bias": 1.72e-4, "update2_high.conv.weight": 1.06e-4,
          "update2_high.flow_head.0.bias": 7.67e-5},
}


@functools.lru_cache(maxsize=None)
def _params(variant="S"):
    return pm.init_params(variant, 0)


def _net(variant="S"):
    return pm._load(tc.fresh(_params(variant)), variant, NUM_FLOWS[variant], torch.float32, "cpu")


def _port_apply(net, f0, f1, t):
    return pm.apply(net, f0, f1, t)


def _jax_apply(variant):
    def run(p, dtype):
        (f0, f1), t, _ = tc.batch(B, HW)
        return jm.apply(p, jnp.asarray(f0, dtype), jnp.asarray(f1, dtype), jnp.asarray(t, dtype), variant=variant,
                        num_flows=NUM_FLOWS[variant])

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


def test_amt_loss_and_gradients_match_jax():
    jloss, jgrads = _jax_param_grads()
    loss, grads = _port_loss_and_grads()
    np.testing.assert_allclose(loss, jloss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, jgrads)


@pytest.mark.parametrize("variant", ("L", "G"))
def test_amt_lg_every_parameter_is_loaded_and_trained(variant):
    _, grads = _port_loss_and_grads(variant)
    _, jgrads = _jax_param_grads(variant)
    assert sorted(grads) == sorted(_params(variant)) and _net(variant).num_flows == 5
    tc.assert_untrained_are_zero_in_jax(grads, jgrads, [])


@pytest.mark.parametrize("variant", ("L", "G"))
def test_amt_lg_loss_and_gradients_match_jax(variant):
    jloss, jgrads = _jax_param_grads(variant)
    loss, grads = _port_loss_and_grads(variant)
    np.testing.assert_allclose(loss, jloss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, jgrads, rtol_by_key={k: 2 * v for k, v in LG_SPREAD[variant].items()})


@pytest.mark.parametrize("variant", ("L", "G"))
def test_amt_lg_bounds_hold_the_other_tensors_at_rifes(variant):
    # one element of the largest gradient outside LG_SPREAD moved by 1e-4 of
    # that gradient's largest: past RIFE's 5e-5, within every LG_SPREAD bound
    _, jgrads = _jax_param_grads(variant)
    _, grads = _port_loss_and_grads(variant)
    key = max((k for k in grads if k not in LG_SPREAD[variant]), key=lambda k: float(jgrads[k].abs().max()))
    moved = dict(grads)
    moved[key] = grads[key].clone()
    moved[key][(0,) * moved[key].dim()] += 1e-4 * float(jgrads[key].abs().max())
    with pytest.raises(AssertionError):
        tc.assert_grads_close(moved, jgrads, rtol_by_key={k: 2 * v for k, v in LG_SPREAD[variant].items()})


def test_train_step_on_a_cpu_mesh_is_the_plain_backward():
    fr, t, target = tc.batch(B, HW)
    loss, grads, deltas = tc.step_on_cpu_mesh(_net, _port_apply, fr, t, target)
    ref_loss, ref_grads = _port_loss_and_grads()
    np.testing.assert_allclose(loss, ref_loss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, ref_grads)
    tc.assert_adam_first_step(grads, deltas)


if __name__ == "__main__":
    for variant in NUM_FLOWS:
        jloss, jgrads = _jax_param_grads(variant)
        loss, grads = _port_loss_and_grads(variant)
        print(f"{variant}: loss {abs(loss - jloss) / abs(jloss):.3g} relative; " + tc.spread_report("port against JAX", grads, jgrads)
              + f"; {len(grads)} parameters, untrained {tc.untrained(grads)}")
