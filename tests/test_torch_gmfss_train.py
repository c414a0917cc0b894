"""GMFSS Fortuna base training in the port against the JAX package's, on the
CPU.

The L1 loss and the gradient of every one of its 289 parameters
(``init_params(0)``, loaded with ``strict=True``) at b1 x 64x64 f32 (GMFSS
pads to multiples of 64) are held against ``jax.value_and_grad`` of the
same loss through JAX ``models/gmfss.py:apply`` (the splats on
``_softsplat_xla``, the warps on ``warp_xla``) in f64: RIFE's tolerance
cannot hold GMFSS against JAX in f32, since JAX's own f32 gradients are
further from its f64 ones than RIFE's 5e-5 allows. The bound is taken from
that spread. On this batch, against JAX f64, JAX's own jitted f32
gradients have a median relative error of 3.51e-4 and a worst of 1.99e-3
(each tensor's largest error over its largest magnitude; the worst after
1e-7 absolute); the port's have 1.73e-6 and 2.90e-4, and on each of the 10
tensors outside RIFE's tolerance the port's error is at most 0.162x JAX
f32's. So the port is held no further from JAX f64 than JAX f32 is: each
gradient within 2e-3 of its tensor's largest magnitude plus 1e-7, the
median within 3.6e-4; the loss within 1e-6 relative (measured 2.5e-8). ``PYTHONPATH=.:tests
python tests/test_torch_gmfss_train.py`` measures these again.

The two tensors that get no gradient in the port are exactly 0 in JAX too:
the PReLU slopes behind a non-negative input (``feat_ext.block1.0`` reads
the frames, ``fusionnet.residual_model_head.0`` the warped frames and
features that are never negative at this batch).

Then torch only: one ``parallel.make_train_step`` step on a CPU mesh gives
the loss and gradients of the plain ``loss.backward()`` and Adam's first
step. One JAX compile in this file: the f64 ``value_and_grad``.
"""

import functools

import numpy as np
import torch

import jax.numpy as jnp

import torch_train_cases as tc
from comfyui_frame_interpolation_tpu.models import gmfss as jm
from comfyui_frame_interpolation_tpu_torch.models import gmfss as pm
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

UNION = False
N_TENSORS = 289
HW = (64, 64)
GRAD_RTOL, MEDIAN_RTOL = 2e-3, 3.6e-4
UNTRAINED = ["feat_ext.block1.0.weight", "fusionnet.residual_model_head.0.weight"]


@functools.lru_cache(maxsize=None)
def _params():
    return pm.init_params(0, union=UNION)


def _net():
    return pm._load(tc.fresh(_params()), UNION, torch.float32, "cpu")


def _port_apply(net, f0, f1, t):
    return pm.apply(net, f0, f1, t)


def _jax_apply(p, dtype):
    (f0, f1), t, _ = tc.batch(1, HW)
    return jm.apply(p, jnp.asarray(f0, dtype), jnp.asarray(f1, dtype), jnp.asarray(t, dtype), union=UNION)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(f64=True):
    _, _, target = tc.batch(1, HW)
    return tc.jax_loss_and_grads(_params(), _jax_apply, target, f64=f64)


@functools.lru_cache(maxsize=None)
def _port_loss_and_grads():
    fr, t, target = tc.batch(1, HW)
    return tc.port_loss_and_grads(_net(), lambda n: _port_apply(n, *(torch.from_numpy(x) for x in (*fr, t))), target)


def _jax_param_grads(f64=True):
    loss, jgrads = _jax_loss_and_grads(f64)
    return loss, tc.jax_param_grads(_net(), jgrads)


def test_every_parameter_is_loaded_and_trained():
    _, grads = _port_loss_and_grads()
    _, jgrads = _jax_param_grads()
    assert sorted(_net().state_dict()) == sorted(_params()) and len(grads) == N_TENSORS
    tc.assert_untrained_are_zero_in_jax(grads, jgrads, UNTRAINED)


def test_gmfss_loss_and_gradients_match_jax_f64():
    jloss, jgrads = _jax_param_grads()
    loss, grads = _port_loss_and_grads()
    np.testing.assert_allclose(loss, jloss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, jgrads, GRAD_RTOL)
    assert tc.median_rel(grads, jgrads) <= MEDIAN_RTOL


def test_train_step_on_a_cpu_mesh_is_the_plain_backward():
    fr, t, target = tc.batch(1, HW)
    loss, grads, deltas = tc.step_on_cpu_mesh(_net, _port_apply, fr, t, target)
    ref_loss, ref_grads = _port_loss_and_grads()
    np.testing.assert_allclose(loss, ref_loss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, ref_grads)
    tc.assert_adam_first_step(grads, deltas)


if __name__ == "__main__":
    # JAX's own spread: its jitted f32 gradients against its f64 ones, beside the port's
    _, ref = _jax_param_grads(True)
    _, j32 = _jax_param_grads(False)
    _, port = _port_loss_and_grads()
    print(tc.spread_report("JAX f32 against JAX f64", j32, ref))
    print(tc.spread_report("port f32 against JAX f64", port, ref))
    rj, rp = tc.rel_errors(j32, ref), tc.rel_errors(port, ref)
    outside = [k for k in rp if rp[k] > tc.GRAD_RTOL]
    print(f"{len(outside)} tensors outside RIFE's tolerance; the port's error over JAX f32's there: at most "
          f"{max((rp[k] / rj[k] if rj[k] > 0 else float('inf')) for k in outside) if outside else 0:.3g}")
    for k in sorted(rp, key=rp.get)[-3:]:
        print(f"  {k}: port {rp[k]:.3g}, JAX f32 {rj[k]:.3g}")
    loss, jloss = _port_loss_and_grads()[0], _jax_loss_and_grads(True)[0]
    print(f"loss {loss:.8f} against JAX f64 {jloss:.8f}: {abs(loss - jloss) / abs(jloss):.3g} relative")
