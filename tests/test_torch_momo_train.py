"""MoMo lite training in the port against the JAX package's, on the CPU.

The L1 loss and the gradient of every one of the 190 parameters of
``momo-lite.pth`` (``init_params(0, "momo-lite.pth")``, conditioned by
``chip_smoke.momo_conditioned`` as ``tests/test_torch_momo.py:_conditioned``
conditions it: the latent head x0.02, the mask head x0.1; loaded with
``strict=True``) at b1 x 64x64 f32 (MoMo takes multiples of 64), through
``apply`` with 2 DDPM steps, are held against ``jax.value_and_grad`` of the
same loss through JAX ``models/momo.py:apply``, jitted, in f32. Both sides
take the same noise, injected: the initial latent and each step's noise
(``init_latents``, ``step_noises``) from numpy. Every parameter gets a
gradient. No hand kernel runs on this path (the synthesis samples through
``grid_sample``).

The tolerance comes from JAX's own spread; RIFE's cannot hold, for JAX
itself:

- On the weights as drawn the denoiser's predictions reach ~10 and clip at
  +-1 (the scheduler's ``clip_sample``): only the pixels that do not clip
  carry a gradient, and which those are turns on rounding. Measured there,
  JAX's jitted f32 gradients lie a median 4.1e-4 (worst 7.7e-4) from its
  f64 ones, the port's 6.4e-4 (1.5e-3), and the port's from JAX f32's 9.7e-4
  (1.9e-3): two f32 spreads, not a fault.
- Conditioned (nothing clips), the flows are the latents times 128 and
  sample random frames, whose bicubic surface is rough, so a gradient still
  moves by ~3e-5 of its size with the order of the f32 sums. Against JAX
  f64: JAX jitted f32 a median 3.22e-5 (worst 5.89e-5), JAX eager f32
  2.80e-5 (5.43e-5), and the port 2.57e-5 to 4.17e-5 (3.93e-5 to 6.66e-5)
  with 2, 1 and 8 torch threads; JAX eager against jitted 2.73e-5 (5.40e-5).
  The port is as far from f64 as JAX's two f32 runs are: no fault to repair.

So the port is held within 2x JAX's own f32 spread of JAX jitted f32: each
gradient within 1.2e-4 of its tensor's largest magnitude plus 1e-7, the
median within 6.5e-5 (measured against JAX f32: median 3.25e-5 to 4.57e-5,
worst 5.66e-5 to 6.98e-5 over 1-8 threads); the loss within 1e-6 relative
(measured 2.1e-7). ``PYTHONPATH=.:tests python
tests/test_torch_momo_train.py`` measures these again (an f64 and an as-drawn
compile besides).

Then torch only: one ``parallel.make_train_step`` step on a CPU mesh gives
the loss and gradients of the plain ``loss.backward()`` and Adam's first
step, with the same injected noise. One JAX compile in this file: the f32
``value_and_grad``.
"""

import functools
import os
import sys

import numpy as np
import torch

import jax.numpy as jnp

import torch_train_cases as tc
from comfyui_frame_interpolation_tpu.models import momo as jm
from comfyui_frame_interpolation_tpu_torch.models import momo as pm
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the script at the repository's root; it imports nothing heavy)

CKPT = "momo-lite.pth"
B, HW, STEPS = 1, (64, 64), 2
N_TENSORS = 190
GRAD_RTOL, MEDIAN_RTOL = 1.2e-4, 6.5e-5


@functools.lru_cache(maxsize=None)
def _params(as_drawn=False):
    sd = pm.init_params(0, CKPT)
    return sd if as_drawn else chip_smoke.momo_conditioned(sd)


def _noises():
    """The initial latent, then one noise per step: NHWC numpy."""
    rng = np.random.default_rng(18)
    return [rng.standard_normal((B, *HW, 4)).astype(np.float32) for _ in range(STEPS + 1)]


def _net(as_drawn=False):
    return pm._load(tc.fresh(_params(as_drawn)), CKPT, torch.float32, "cpu")


def _nchw(x):
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _port_apply(net, f0, f1, t):
    noise = [_nchw(torch.from_numpy(n)) for n in _noises()]
    return pm.apply(net, _nchw(f0), _nchw(f1), STEPS, init_latents=noise[0], step_noises=noise[1:]).permute(0, 2, 3, 1)


def _jax_apply(p, dtype):
    (f0, f1), _, _ = tc.batch(B, HW)
    noise = [jnp.asarray(n, dtype) for n in _noises()]
    return jm.apply(p, jnp.asarray(f0, dtype), jnp.asarray(f1, dtype), None, STEPS, CKPT, init_latents=noise[0],
                    step_noises=noise[1:])


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(f64=False, as_drawn=False):
    _, _, target = tc.batch(B, HW)
    return tc.jax_loss_and_grads(_params(as_drawn), _jax_apply, target, f64=f64)


def _jax_param_grads(f64=False, as_drawn=False):
    loss, jgrads = _jax_loss_and_grads(f64, as_drawn)
    return loss, tc.jax_param_grads(_net(), jgrads)


@functools.lru_cache(maxsize=None)
def _port_loss_and_grads(as_drawn=False):
    fr, t, target = tc.batch(B, HW)
    return tc.port_loss_and_grads(_net(as_drawn), lambda n: _port_apply(n, *(torch.from_numpy(x) for x in (*fr, t))), target)


def test_every_parameter_is_loaded_and_trained():
    _, grads = _port_loss_and_grads()
    _, jgrads = _jax_param_grads()
    assert sorted(_net().state_dict()) == sorted(_params()) and len(grads) == N_TENSORS
    tc.assert_untrained_are_zero_in_jax(grads, jgrads, [])


def test_momo_loss_and_gradients_match_jax():
    jloss, jgrads = _jax_param_grads()
    loss, grads = _port_loss_and_grads()
    np.testing.assert_allclose(loss, jloss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, jgrads, GRAD_RTOL)
    assert tc.median_rel(grads, jgrads) <= MEDIAN_RTOL


def test_train_step_on_a_cpu_mesh_is_the_plain_backward():
    fr, t, target = tc.batch(B, HW)
    loss, grads, deltas = tc.step_on_cpu_mesh(_net, _port_apply, fr, t, target)
    ref_loss, ref_grads = _port_loss_and_grads()
    np.testing.assert_allclose(loss, ref_loss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, ref_grads)
    tc.assert_adam_first_step(grads, deltas)


if __name__ == "__main__":
    for as_drawn in (True, False):
        jl32, j32 = _jax_param_grads(False, as_drawn)
        jl64, j64 = _jax_param_grads(True, as_drawn)
        loss, port = _port_loss_and_grads(as_drawn)
        print("as drawn" if as_drawn else "conditioned", f"{len(port)} parameters, untrained {tc.untrained(port)}")
        print(f"  loss port {loss:.9f} JAX f32 {jl32:.9f} f64 {jl64:.9f}")
        print("  " + tc.spread_report("port against JAX f32", port, j32))
        print("  " + tc.spread_report("JAX f32 against JAX f64", j32, j64))
        print("  " + tc.spread_report("port against JAX f64", port, j64))
    # conditioned: JAX eager against jitted, and the port with 1, 2 and 8 torch threads
    _, target = None, tc.batch(B, HW)[2]
    _, eager = tc.jax_loss_and_grads(_params(), _jax_apply, target, jit=False)
    eager = tc.jax_param_grads(_net(), eager)
    print(tc.spread_report("JAX eager f32 against JAX f64", eager, j64))
    print(tc.spread_report("JAX eager against JAX jitted", eager, j32))
    for n, (_, g) in tc.by_threads(lambda: _port_loss_and_grads.__wrapped__(False), (1, 2, 8)).items():
        print(f"  {n} torch threads: " + tc.spread_report("port against JAX f64", g, j64) + "; "
              + tc.spread_report("against JAX jitted f32", g, j32))
