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
step.

ATM base with ``ensemble_global_motion=True`` is held the same way, with
RIFE's tolerance: the global motion estimated at three input scales and
picked per sample by its photometric loss (JAX
``models/atm.py:_multiscale_global_ensemble``; the scales' frame warps
feed only that pick, so on the card they launch no backward). On the batch
of seed 16 both packages pick the full scale, whose flows are the
ensemble-free ones (the loss the same, bit for bit, in JAX too), so this
case takes the batch of seed 19 (``ENSEMBLE_SEED``), on which the pick is
another scale (the prediction 0.69 from the ensemble-free one). Its
gradients are held within RIFE's 5e-5 of each tensor's largest plus 1e-7,
but for the five tensors of ``ENSEMBLE_SPREAD``, each held within 2.4x its
measured gap. That gap is JAX's own f32 rounding: JAX's jitted f32
gradients lie 4.16e-3 from its f64 ones at ``refine_head.0.0.bias`` (4.16e-3
from its eager f32 too), where the port's f32 ones are within 1.6e-7 of
JAX's f64 (1.1e-6 of its eager f32, 1.03e-7 between the port's runs at 1,
2, 4 and 8 threads); ``ENSEMBLE_SPREAD`` gives the port's distance from
JAX's jitted f32 per tensor, every other tensor within 1.6e-6. JAX's f64
compile of this case takes ~80 s and ~9 GB here, its eager f32 ~130 s, so
the file takes JAX's jitted f32. Two tensors get no gradient in the port
and exactly 0 in JAX (``ENSEMBLE_UNTRAINED``): the global-motion
transformer's query and first MLP weights, at the scale picked. One JAX
compile per configuration in this file: the ``value_and_grad``.
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
from torch_train_cases import release_module_caches  # noqa: F401  (autouse: drops the caches after the module)

N_STATE, N_TENSORS = 236, 232
B, HW = 1, (64, 64)
VARIANTS = ("base", "lite")
ENSEMBLE_SEED = 19  # a batch on which the ensemble picks a scale other than the full one
ENSEMBLE_UNTRAINED = ["global_motion_atmformer.0.attn.mlp.0.weight", "global_motion_atmformer.0.attn.q.weight"]
# the tensors past 5e-5: the port's distance from JAX's jitted f32, the
# same at 1, 2, 4 and 8 torch threads (JAX's f32 rounding; the docstring)
ENSEMBLE_SPREAD = {"refine_head.0.0.bias": 4.16e-3, "refine_head.0.0.weight": 3.0e-3, "up3.0.0.bias": 1.05e-3,
                   "proj.0.bias": 7.56e-4, "proj.0.weight": 3.55e-4}


@functools.lru_cache(maxsize=None)
def _params(variant):
    return pm.init_params(variant, 0)


def _net(variant):
    return pm._load(tc.fresh(_params(variant)), variant, torch.float32, "cpu")


def _port_apply(net, f0, f1, t, ensemble=False):
    return pm.apply(net, f0, f1, global_motion=True, ensemble_global_motion=ensemble)


def _seed(ensemble):
    return ENSEMBLE_SEED if ensemble else 16


def _jax_apply(variant, ensemble=False):
    def run(p, dtype):
        (f0, f1), _, _ = tc.batch(B, HW, seed=_seed(ensemble))
        return jm.apply(p, jnp.asarray(f0, dtype), jnp.asarray(f1, dtype), None, variant=variant, global_motion=True,
                        ensemble_global_motion=ensemble)

    return run


@functools.lru_cache(maxsize=None)
def _jax_param_grads(variant, ensemble=False):
    _, _, target = tc.batch(B, HW, seed=_seed(ensemble))
    loss, jgrads = tc.jax_loss_and_grads(_params(variant), _jax_apply(variant, ensemble), target)
    return loss, tc.jax_param_grads(_net(variant), jgrads)


@functools.lru_cache(maxsize=None)
def _port_loss_and_grads(variant, ensemble=False):
    fr, t, target = tc.batch(B, HW, seed=_seed(ensemble))
    return tc.port_loss_and_grads(_net(variant), lambda n: _port_apply(n, *(torch.from_numpy(x) for x in (*fr, t)), ensemble), target)


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


def test_base_ensemble_every_parameter_is_loaded_and_trained():
    _, grads = _port_loss_and_grads("base", True)
    _, jgrads = _jax_param_grads("base", True)
    assert len(grads) == N_TENSORS
    tc.assert_untrained_are_zero_in_jax(grads, jgrads, ENSEMBLE_UNTRAINED)


def test_base_ensemble_loss_and_gradients_match_jax():
    jloss, jgrads = _jax_param_grads("base", True)
    loss, grads = _port_loss_and_grads("base", True)
    fr, _, _ = tc.batch(B, HW, seed=ENSEMBLE_SEED)
    with torch.no_grad():
        alone = _port_apply(_net("base"), *(torch.from_numpy(x) for x in fr), None)
        picked = _port_apply(_net("base"), *(torch.from_numpy(x) for x in fr), None, True)
    assert float((alone - picked).abs().max()) > 0.1  # the pick is not the full scale's
    np.testing.assert_allclose(loss, jloss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, jgrads, rtol_by_key={k: 2.4 * v for k, v in ENSEMBLE_SPREAD.items()})


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
    jloss, jgrads = _jax_param_grads("base", True)
    loss, grads = _port_loss_and_grads("base", True)
    print(f"base, ensemble: loss {abs(loss - jloss) / abs(jloss):.3g} relative; " + tc.spread_report("port against JAX", grads, jgrads)
          + f"; untrained {tc.untrained(grads)}")
