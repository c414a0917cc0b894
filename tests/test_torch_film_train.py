"""FILM training in the port against the JAX package's, on the CPU.

The L1 loss and the gradient of every one of the 82 parameters of
``film_net_fp32.pt`` (``init_params(0)``, loaded with ``strict=True``) at
b1 x 64x64 f32 (FILM takes any size; its 7-level pyramid is a pixel at the
coarsest here) are held against ``jax.value_and_grad`` of the same loss
through JAX ``models/film.py:apply`` (the warps on ``warp_xla``), jitted, in
f32. ``timestep`` is ignored by both, as in the reference. Every parameter
gets a gradient. The port's warps are border-mode: its 5 image warps (C =
3) and 11 feature warps (C >= 32, the wide kernel on the card) each need the
flow's gradient, and the feature warps also the image's.

Held with RIFE's tolerance: the loss within 1e-6 relative (measured
1.1e-7), each gradient within 5e-5 of its tensor's largest magnitude plus
1e-7 (measured: median 6.7e-7, worst 3.02e-5 at ``fuse.convs.3.2.0.bias``,
a bias gradient summed over every pixel, the same with 1, 2, 4 and 8 torch
threads). JAX's own jitted f32 gradients lie a median 3.6e-7 and at worst
1.06e-5 from its f64 ones, the port's 7.4e-7 and 2.78e-5.
``PYTHONPATH=.:tests python tests/test_torch_film_train.py`` measures these
again.

Then torch only: one ``parallel.make_train_step`` step on a CPU mesh gives
the loss and gradients of the plain ``loss.backward()`` and Adam's first
step. One JAX compile in this file: the f32 ``value_and_grad``.
"""

import functools

import numpy as np
import torch

import jax.numpy as jnp

import torch_train_cases as tc
from comfyui_frame_interpolation_tpu.models import film as jm
from comfyui_frame_interpolation_tpu_torch.models import film as pm
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

N_TENSORS = 82
B, HW = 1, (64, 64)


@functools.lru_cache(maxsize=None)
def _params():
    return pm.init_params(0)


def _net():
    return pm._load(tc.fresh(_params()), torch.float32, "cpu")


def _port_apply(net, f0, f1, t):
    return pm.apply(net, f0, f1, t)


def _jax_apply(p, dtype):
    (f0, f1), t, _ = tc.batch(B, HW)
    return jm.apply(p, jnp.asarray(f0, dtype), jnp.asarray(f1, dtype), jnp.asarray(t, dtype))


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
    assert sorted(grads) == sorted(_params()) and len(grads) == N_TENSORS
    tc.assert_untrained_are_zero_in_jax(grads, jgrads, [])


def test_film_loss_and_gradients_match_jax():
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
    print(f"loss {abs(loss - jloss) / abs(jloss):.3g} relative to JAX f32")
    print(tc.spread_report("port f32 against JAX f32", port, j32))
    rp = tc.rel_errors(port, j32)
    print("worst:", max(rp, key=rp.get), "; untrained:", tc.untrained(port))
    for n, (_, g) in tc.by_threads(lambda: _port_loss_and_grads.__wrapped__()).items():
        print(f"  {n} torch threads: " + tc.spread_report("port f32 against JAX f32", g, j32))
    _, ref = _jax_param_grads(True)
    print(tc.spread_report("JAX f32 against JAX f64", j32, ref))
    print(tc.spread_report("port f32 against JAX f64", port, ref))
