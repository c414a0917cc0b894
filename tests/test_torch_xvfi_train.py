"""XVFI Vimeo and X4K training in the port against the JAX package's, on the CPU.

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
first step.

X4K (``XVFInet_X4K1000FPS_exp1_latest.pt``: 74 state-dict tensors, scale 4,
``S_tst`` 5) is held at b1 x 512x512: X4K divides by ``2**S_tst * scale *
4`` = 512, and no smaller frame runs in either package (every size from
32x32 to 448x448, and 512 rows by 64-256 columns, fails in both: the
coarsest level's 4x4 convolution or average pool gets no pixel). Its five
levels run the reference's shared ``rec_ext_ds`` and flow nets five times
and its CFR splat once. Against JAX's jitted f32 (its f64 compile takes
~250 s here, its f32 one ~30 s): the loss within RIFE's 1e-6 relative
(measured 5.3e-7), each gradient within RIFE's 5e-5 of its tensor's
largest plus 1e-7, the same four tensors untrained, but for the two bias
gradients of ``X4K_SPREAD``, each held within twice its measured spread.
The f32 sums over a 512x512 frame set those: against the port's own f64
step, the port's f32 gradients lie within 4.88e-4
(``vfinet.refine_unet.dec3.bias``, a bias gradient summed over 262,144
pixels by torch's CPU convolution backward, the same at 1, 2, 4 and 8
threads; 6.5e-5 on 0.1332) and JAX's f32 ones within 2.0e-4
(``vfinet.conv_flow3.10.bias``); the port against JAX f32 measured 4.87e-4
there, and 4.61e-5 at ``vfinet.refine_unet.dec0.bias``, which moves by
4.59e-5 between the port's own runs at 1, 2, 4 and 8 threads (every other
tensor within 8.2e-6 of JAX's). One JAX compile
per checkpoint in this file: Vimeo's f64 ``value_and_grad``, X4K's f32.
"""

import functools

import numpy as np
import torch

import jax.numpy as jnp

import torch_train_cases as tc
from comfyui_frame_interpolation_tpu.models import xvfi as jm
from comfyui_frame_interpolation_tpu_torch.models import xvfi as pm
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)
from torch_train_cases import release_module_caches  # noqa: F401  (autouse: drops the caches after the module)

CKPT = "XVFInet_Vimeo_exp1_latest.pt"
X4K = "XVFInet_X4K1000FPS_exp1_latest.pt"
SCALE, S_TST = 2, 1
N_STATE, N_TENSORS = 72, 68
B, HW = 2, (64, 64)
# X4K's batch: the smallest frame that all five levels run on in both packages
X4K_B, X4K_HW = 1, (512, 512)
# the tensors past half of 5e-5: the port's largest distance from JAX's f32
# over 1, 2, 4 and 8 torch threads (the docstring)
X4K_SPREAD = {"vfinet.refine_unet.dec3.bias": 4.87e-4, "vfinet.refine_unet.dec0.bias": 4.61e-5}
X4K_UNTRAINED = [f"vfinet.refine_unet.{m}.{p}" for m in ("conv1", "conv2") for p in ("weight", "bias")]
UNTRAINED = [f"vfinet.refine_unet.{m}.{p}" for m in ("conv1", "conv2") for p in ("weight", "bias")]


def _shape(ckpt):
    return (B, HW) if ckpt == CKPT else (X4K_B, X4K_HW)


@functools.lru_cache(maxsize=None)
def _params(ckpt=CKPT):
    return pm.init_params(ckpt, 0)


def _net(ckpt=CKPT):
    return pm._load(tc.fresh(_params(ckpt)), pm.CKPT_CONFIGS[ckpt]["module_scale_factor"], torch.float32, "cpu")


def _port_apply(net, f0, f1, t, s_tst=S_TST):
    return pm.apply(net, f0, f1, t, s_tst)


def _jax_apply(ckpt):
    cfg = pm.CKPT_CONFIGS[ckpt]

    def run(p, dtype):
        (f0, f1), t, _ = tc.batch(*_shape(ckpt))
        return jm.apply(p, jnp.asarray(f0, dtype), jnp.asarray(f1, dtype), jnp.asarray(t),
                        module_scale_factor=cfg["module_scale_factor"], s_tst=cfg["S_tst"])

    return run


@functools.lru_cache(maxsize=None)
def _jax_param_grads(ckpt=CKPT):
    _, _, target = tc.batch(*_shape(ckpt))
    loss, jgrads = tc.jax_loss_and_grads(_params(ckpt), _jax_apply(ckpt), target, f64=ckpt == CKPT)
    return loss, tc.jax_param_grads(_net(ckpt), jgrads)


@functools.lru_cache(maxsize=None)
def _port_loss_and_grads(ckpt=CKPT):
    fr, t, target = tc.batch(*_shape(ckpt))
    s_tst = pm.CKPT_CONFIGS[ckpt]["S_tst"]
    return tc.port_loss_and_grads(_net(ckpt), lambda n: _port_apply(n, *(torch.from_numpy(x) for x in (*fr, t)), s_tst), target)


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


def test_x4k_every_parameter_is_loaded_and_trained():
    _, grads = _port_loss_and_grads(X4K)
    _, jgrads = _jax_param_grads(X4K)
    assert sorted(_net(X4K).state_dict()) == sorted(_params(X4K)) and len(_params(X4K)) == 74
    tc.assert_untrained_are_zero_in_jax(grads, jgrads, X4K_UNTRAINED)


def test_x4k_loss_and_gradients_match_jax():
    jloss, jgrads = _jax_param_grads(X4K)
    loss, grads = _port_loss_and_grads(X4K)
    np.testing.assert_allclose(loss, jloss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, jgrads, rtol_by_key={k: 2 * v for k, v in X4K_SPREAD.items()})


def test_train_step_on_a_cpu_mesh_is_the_plain_backward():
    fr, t, target = tc.batch(B, HW)
    loss, grads, deltas = tc.step_on_cpu_mesh(_net, _port_apply, fr, t, target)
    ref_loss, ref_grads = _port_loss_and_grads()
    np.testing.assert_allclose(loss, ref_loss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, ref_grads)
    tc.assert_adam_first_step(grads, deltas)


if __name__ == "__main__":
    for ckpt in (CKPT, X4K):
        jloss, jgrads = _jax_param_grads(ckpt)
        loss, grads = _port_loss_and_grads(ckpt)
        print(f"{ckpt}: loss {abs(loss - jloss) / abs(jloss):.3g} relative; " + tc.spread_report("port against JAX", grads, jgrads)
              + f"; {len(grads)} parameters, untrained {tc.untrained(grads)}")
