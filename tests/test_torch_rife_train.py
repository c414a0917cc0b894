"""RIFE training for every arch but 4.7 without the ensemble (held in
``tests/test_torch_parallel.py``), in the port against the JAX package's, on
the CPU.

The L1 loss and the gradient of every parameter (``init_params(0, arch)``,
loaded with ``strict=True``) at b2 x 64x64 are held against
``jax.value_and_grad`` of the same loss through JAX ``models/rife.py:apply``
(the warps on ``warp_xla``), jitted once per configuration with the weights
and the batch as its arguments, with RIFE's tolerance: the loss within 1e-6
relative, each gradient within 5e-5 of its tensor's largest magnitude plus
1e-7. In f64 but for 4.2, because JAX's own f32 gradients are not within
that tolerance of its f64 ones (measured: 4.10 and 4.17
``block3.convblock.1.conv.bias`` 2.8e-3 of its largest, a sum over every
pixel that nearly cancels; 4.0 4.1e-4, and 3.4e-3 on the mixed batch), nor
the port's (4.0's f32 weight gradient of the ``unet.up2.0`` transposed
convolution, on torch's CPU kernels, 1.35e-2 from f64 at 1 to 8 threads).
In f64 the port's worst tensor is 5.7e-6 (4.0's restart), the loss within
5.9e-8. 4.2 is held in f32 (measured: every tensor within the 1e-7, JAX's
own f32 and f64 alike): JAX's ``bilinear_sample`` takes its coordinates in
f32 for any image dtype (JAX ``ops/warp.py:75``), and in f64, where the
port's warp takes them in f64, one of 4.2's samples sits where that
rounding moves it across a tap (``unet.down0.conv1.0.bias`` 3.4e-3 from
JAX's f64). The cases:

* 4.0 with ``fastmode=False`` (PReLU blocks with the residual, the
  Contextnet/Unet refinement), its restart with doubled scales not taken,
  taken, and on a mixed batch where the first sample alone would take it
  (block 1's head scaled by ``k``, as ``tests/test_torch_rife.py`` does for
  the forward; ``k`` from the stage-1 updates in f64, so that the weights
  do not move with the thread count: the restart's flows reach tens of
  pixels, where JAX's f32 warp coordinates meet a tap that the port's f64
  ones do not for some ``k``, 5.4e-2 on a PReLU weight's gradient with ``k``
  from an f32 run at 2 threads). The three share one compile: JAX's
  ``lax.cond`` compiles both branches, and the weights are an argument;
* 4.2 with ``fastmode=False`` (plain LeakyReLU blocks and the refinement);
  4.5 (ResConv blocks, no encoder); 4.10 and 4.17 (their encoders, whose
  8-channel features are warped with the image); 4.26 (five blocks and the
  feature threading); 4.7 with the ensemble.

Every parameter gets a gradient in every case, and JAX's zero set is the
port's (``assert_untrained_are_zero_in_jax``); ``python
tests/test_torch_rife_train.py`` prints each case's gaps.

4.3 and 4.6 run exactly 4.2's and 4.5's code in both packages (the arch
tuples of JAX ``models/rife.py:99, 262, 279, 289, 388`` and the port's
``_ARCH``, ``_PLAIN``, ``_NO_ENCODER``): each is held bit for bit to its
twin arch in the port (the same state-dict keys and shapes, the same scale
list, the same loss and gradients on the same weights), with no JAX
compile. Then torch only: one ``parallel.make_train_step`` step of 4.0 (the
restart taken: its host-side flag inside the step) on a CPU mesh gives the
loss and gradients of the plain ``loss.backward()`` and Adam's first step.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_train_cases as tc
from comfyui_frame_interpolation_tpu import parallel as jparallel
from comfyui_frame_interpolation_tpu.models import rife as jm
from comfyui_frame_interpolation_tpu.utils.ckpt import nest_state_dict, to_jax_tree
from comfyui_frame_interpolation_tpu_torch.models import rife as pm
from comfyui_frame_interpolation_tpu_torch.utils.ckpt import params_from_jax
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)
from torch_train_cases import release_module_caches  # noqa: F401  (autouse: drops the caches after the module)

B, HW = 2, (64, 64)
F32_CASES = ("4.2 refined",)  # the rest in f64: the docstring says why
# (arch, ensemble, fastmode, the 4.0 restart's branch or None)
CASES = {
    "4.0 refined, no restart": ("4.0", False, False, "normal"),
    "4.0 refined, restart": ("4.0", False, False, "rescued"),
    "4.0 refined, mixed batch": ("4.0", False, False, "mixed"),
    "4.2 refined": ("4.2", False, False, None),
    "4.5": ("4.5", False, True, None),
    "4.10": ("4.10", False, True, None),
    "4.17": ("4.17", False, True, None),
    "4.26": ("4.26", False, True, None),
    "4.7 ensemble": ("4.7", True, True, None),
}
# the archs that run another arch's code in both packages
TWINS = {"4.3": "4.2", "4.6": "4.5"}


def _dtype(case):
    return np.float32 if case in F32_CASES else np.float64


def _batch(branch, dtype=np.float64):
    """The frames, t and target in ``dtype`` (``branch`` aside: every case
    takes the same batch, whose first sample's stage-1 update exceeds 32
    pixels at a smaller head scale than the second's)."""
    (f0, f1), t, target = tc.batch(B, HW)
    return tuple(x.astype(dtype) for x in (f0, f1, t, target))


def _net(sd, arch, dtype=torch.float64):
    net = pm.IFNet(arch)
    net.load_state_dict(tc.fresh(sd), strict=True)
    return net.to(dtype=dtype, memory_format=torch.channels_last)


def _stage1_updates(sd, f0, f1, t):
    """Per sample, 4.0's largest stage-1 flow update in each direction, in
    f64 (so that the head's scale, and the case, do not move with the
    order of f32 sums): what the restart's flag reduces over the batch."""
    net = _net(sd, "4.0")
    scales = pm.default_scale_list("4.0")
    with torch.inference_mode():
        img0, img1 = (torch.from_numpy(f).permute(0, 3, 1, 2) for f in (f0, f1))
        tmap = torch.from_numpy(t).reshape(-1, 1, 1, 1).expand(-1, 1, *img0.shape[2:])
        blocks = net.blocks()
        flow, mask, _ = pm._if_block(blocks[0], [img0, img1, tmap], None, scales[0])
        w0, w1 = pm._warp_both(img0, img1, flow)
        fd, _, _ = pm._if_block(blocks[1], [w0, w1, tmap, mask], flow, scales[1])
    return fd[:, :2].abs().amax((1, 2, 3)).numpy(), fd[:, 2:4].abs().amax((1, 2, 3)).numpy()


@functools.lru_cache(maxsize=None)
def _params(case):
    """The case's weights: ``init_params(0, arch)``, and for 4.0 block 1's
    head times the ``k`` that puts the batch in the case's branch."""
    arch, _, _, branch = CASES[case]
    sd = pm.init_params(0, arch)
    if branch is None:
        return sd
    f0, f1, t, _ = _batch(branch)
    a, b = _stage1_updates(sd, f0, f1, t)
    batch_at, loud_at, quiet_at = 32 / min(a.max(), b.max()), 32 / min(a[0], b[0]), 32 / min(a[1], b[1])
    assert loud_at < quiet_at
    k = {"normal": 0.5 * batch_at, "rescued": 1.2 * quiet_at, "mixed": (loud_at * quiet_at) ** 0.5}[branch]
    sd = dict(sd)
    for key in ("block1.lastconv.weight", "block1.lastconv.bias"):
        sd[key] = sd[key] * k
    a, b = _stage1_updates(sd, f0, f1, t)
    flags = [bool(a[i] > 32 and b[i] > 32) for i in range(B)]
    assert flags == {"normal": [False, False], "rescued": [True, True], "mixed": [True, False]}[branch], (branch, a, b)
    return sd


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch, ensemble, fastmode):
    """``jax.value_and_grad`` of the L1 loss, jitted, over ``(params, f0, f1,
    t, target)`` (called in f64): one compile per configuration (JAX's ``lax.cond`` compiles
    both of 4.0's branches)."""
    scales = jm.default_scale_list(arch)

    def loss_fn(params, f0, f1, t, target):
        pred = jm.apply(params, f0, f1, t, scales, arch_ver=arch, fastmode=fastmode, ensemble=ensemble)
        return jparallel.l1_loss(pred, target)

    return jax.jit(jax.value_and_grad(loss_fn))


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(case):
    arch, ensemble, fastmode, branch = CASES[case]
    dtype = _dtype(case)
    with jax.enable_x64(dtype == np.float64):
        params = to_jax_tree(nest_state_dict({k: v.to(torch.from_numpy(np.zeros(0, dtype)).dtype) for k, v in _params(case).items()}))
        loss, grads = _jax_value_and_grad(arch, ensemble, fastmode)(params, *(jnp.asarray(x) for x in _batch(branch, dtype)))
    return float(loss), {k: torch.from_numpy(np.asarray(v, np.float64)) for k, v in params_from_jax(grads).items()}


def _port_apply(arch, ensemble, fastmode):
    scales = pm.default_scale_list(arch)

    def run(net, f0, f1, t):
        return pm.apply(net, f0, f1, t, scales, ensemble=ensemble, fastmode=fastmode)

    return run


def _port_loss_and_grads_of(sd, arch, ensemble, fastmode, branch, dtype=np.float64):
    f0, f1, t, target = _batch(branch, dtype)
    run = _port_apply(arch, ensemble, fastmode)
    net = _net(sd, arch, torch.from_numpy(np.zeros(0, dtype)).dtype)
    return tc.port_loss_and_grads(net, lambda n: run(n, *(torch.from_numpy(x) for x in (f0, f1, t))), target)


@functools.lru_cache(maxsize=None)
def _port_loss_and_grads(case):
    return _port_loss_and_grads_of(_params(case), *CASES[case], _dtype(case))


@pytest.mark.parametrize("case", CASES)
def test_every_parameter_is_loaded_and_trained(case):
    _, grads = _port_loss_and_grads(case)
    _, jgrads = _jax_loss_and_grads(case)
    assert sorted(grads) == sorted(_params(case)) == sorted(jgrads)
    tc.assert_untrained_are_zero_in_jax(grads, jgrads, [])


@pytest.mark.parametrize("case", CASES)
def test_rife_loss_and_gradients_match_jax(case):
    jloss, jgrads = _jax_loss_and_grads(case)
    loss, grads = _port_loss_and_grads(case)
    np.testing.assert_allclose(loss, jloss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, jgrads)


@pytest.mark.parametrize("arch,twin", TWINS.items())
def test_arch_runs_its_twins_code_bit_for_bit(arch, twin):
    """``arch`` has ``twin``'s state-dict keys and shapes and scale list, and
    on ``twin``'s weights the same loss and gradients, bit for bit (4.3 with
    the refinement, as 4.2 is held)."""
    fastmode = twin != "4.2"
    assert {k: v.shape for k, v in pm.init_params(0, arch).items()} == {k: v.shape for k, v in pm.init_params(0, twin).items()}
    assert pm.default_scale_list(arch) == pm.default_scale_list(twin)
    sd = pm.init_params(0, twin)
    loss, grads = _port_loss_and_grads_of(sd, arch, False, fastmode, None)
    tloss, tgrads = _port_loss_and_grads_of(sd, twin, False, fastmode, None)
    assert loss == tloss
    assert grads.keys() == tgrads.keys() and all(torch.equal(grads[k], tgrads[k]) for k in grads)


def test_train_step_on_a_cpu_mesh_is_the_plain_backward():
    case = "4.0 refined, restart"
    arch, ensemble, fastmode, branch = CASES[case]
    f0, f1, t, target = _batch(branch)
    loss, grads, deltas = tc.step_on_cpu_mesh(lambda: _net(_params(case), arch), _port_apply(arch, ensemble, fastmode),
                                              (f0, f1), t, target)
    ref_loss, ref_grads = _port_loss_and_grads(case)
    np.testing.assert_allclose(loss, ref_loss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, ref_grads)
    tc.assert_adam_first_step(grads, deltas)


if __name__ == "__main__":
    for case in CASES:
        jloss, jgrads = _jax_loss_and_grads(case)
        loss, grads = _port_loss_and_grads(case)
        print(f"{case}: loss {abs(loss - jloss) / abs(jloss):.3g} relative; " + tc.spread_report("port against JAX", grads, jgrads)
              + f"; {len(grads)} parameters, untrained {tc.untrained(grads)}")
