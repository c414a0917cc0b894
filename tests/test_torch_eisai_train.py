"""EISAI training in the port against the JAX package's, on the CPU.

The L1 loss and the gradient of every one of its 333 parameters
(``init_params(0)``: the RFR flow net, SoftsplatLite and DTM, loaded with
``strict=True``) at b1 x 64x96 f32 with 2 RAFT iterations are held against
``jax.value_and_grad`` of the same loss through JAX ``models/eisai.py:apply``
(the splats on ``_softsplat_xla``, the Lab warps on ``warp_xla``), jitted, in
f32: JAX cannot run EISAI in f64 (RAFT's scan carries are f32, JAX
``models/eisai.py:403``), and RIFE's tolerance cannot hold it against JAX's
jitted gradients, since those are as far from JAX's own eager ones. The
bound is taken from that spread. On this batch, JAX's jitted f32 gradients
against its eager f32 ones have a median relative error of 9.49e-4 and a
worst of 4.39e-3 (each tensor's largest error over its largest magnitude;
the worst after 1e-7 absolute); the port against JAX eager is within
RIFE's tolerance on every tensor (median 1.11e-6, worst 1.35e-6), and so
against JAX jit as far as JAX eager is (median 9.50e-4, worst 4.39e-3). So
the port is held within 1.5x JAX's own jit-to-eager spread of JAX jit: each
gradient within 6.6e-3 of its tensor's largest magnitude plus 1e-7, the
median within 1.4e-3; the loss within 1e-6 relative (measured 2.1e-7).
``PYTHONPATH=.:tests python tests/test_torch_eisai_train.py`` measures
these again (JAX eager takes ~2 min).

The eight tensors of RAFT's ``attention2``, which the forward never reads
(RFR's ``flow_init`` branch, not ported; its weights stay in the state
dict), get no gradient in the port and exactly 0 in JAX; so do the first
PReLU slopes of the three ``ssl.gridnet_converter`` nets, which read ResNet
features after a ReLU (never negative).

Then torch only: one ``parallel.make_train_step`` step on a CPU mesh gives
the loss and gradients of the plain ``loss.backward()`` and Adam's first
step. One JAX compile in this file: the jitted ``value_and_grad``.
"""

import functools

import numpy as np
import torch

import jax.numpy as jnp

import torch_train_cases as tc
from comfyui_frame_interpolation_tpu.models import eisai as jm
from comfyui_frame_interpolation_tpu_torch.models import eisai as pm
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

N_TENSORS = 333
HW = (64, 96)
ITERS = 2
GRAD_RTOL, MEDIAN_RTOL = 6.6e-3, 1.4e-3
UNTRAINED = [f"raft.attention2.{m}.{p}" for m in ("conv1", "conv2", "conv3") for p in ("weight", "bias")] + [
    f"raft.attention2.prelu{i}.weight" for i in (1, 2)
] + [f"ssl.gridnet_converter.nets.{i}.0.weight" for i in range(3)]


@functools.lru_cache(maxsize=None)
def _params():
    return pm.init_params(0)


def _net():
    return pm._load(tc.fresh(_params()), torch.float32, "cpu")


def _port_apply(net, f0, f1, t):
    return pm.apply(net, f0, f1, t, iters=ITERS)


def _jax_apply(p, dtype):
    (f0, f1), t, _ = tc.batch(1, HW)
    return jm.apply(p, jnp.asarray(f0, dtype), jnp.asarray(f1, dtype), jnp.asarray(t, dtype).reshape(-1, 1, 1, 1), iters=ITERS)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(jit=True):
    _, _, target = tc.batch(1, HW)
    return tc.jax_loss_and_grads(_params(), _jax_apply, target, jit=jit)


@functools.lru_cache(maxsize=None)
def _port_loss_and_grads():
    fr, t, target = tc.batch(1, HW)
    return tc.port_loss_and_grads(_net(), lambda n: _port_apply(n, *(torch.from_numpy(x) for x in (*fr, t))), target)


def _jax_param_grads(jit=True):
    loss, jgrads = _jax_loss_and_grads(jit)
    return loss, tc.jax_param_grads(_net(), jgrads)


def test_every_parameter_is_loaded_and_trained():
    _, grads = _port_loss_and_grads()
    _, jgrads = _jax_param_grads()
    assert sorted(_net().state_dict()) == sorted(_params()) and len(grads) == N_TENSORS
    tc.assert_untrained_are_zero_in_jax(grads, jgrads, UNTRAINED)


def test_eisai_loss_and_gradients_match_jax_jit():
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
    # JAX's own spread: its jitted gradients against its eager ones, beside the port's
    _, j32 = _jax_param_grads(True)
    _, ref = _jax_param_grads(False)
    _, port = _port_loss_and_grads()
    print(tc.spread_report("JAX jit against JAX eager", j32, ref))
    print(tc.spread_report("port against JAX eager", port, ref))
    print(tc.spread_report("port against JAX jit", port, j32))
    rj, rp = tc.rel_errors(j32, ref), tc.rel_errors(port, ref)
    outside = [k for k in rp if rp[k] > tc.GRAD_RTOL]
    print(f"{len(outside)} tensors outside RIFE's tolerance against JAX eager; the port's error over JAX jit's there: at most "
          f"{max((rp[k] / rj[k] if rj[k] > 0 else float('inf')) for k in outside) if outside else 0:.3g}")
    for k in sorted(rp, key=rp.get)[-3:]:
        print(f"  {k}: port {rp[k]:.3g}, JAX jit {rj[k]:.3g}")
    loss, jloss = _port_loss_and_grads()[0], _jax_loss_and_grads(True)[0]
    print(f"loss {loss:.8f} against JAX jit {jloss:.8f}: {abs(loss - jloss) / abs(jloss):.3g} relative")
    print("untrained:", tc.untrained(port))
