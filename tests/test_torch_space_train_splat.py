"""The training step on the ``space`` axis of the port's ``parallel/`` (rows
split over devices) for the families that splat, on logical replicas of the
CPU: M2M, XVFI Vimeo, GMFSS Fortuna base and union and EISAI (2
iterations), built as their one-device train tests build them
(``tests/torch_space_train_cases.py``).

Each band's sources splat into a whole-frame f32 partial with a gradient
(``parallel.space._softsplat_rule``, ``ops.softsplat.softsplat_partial``);
AMT's correlation and EISAI's all-pairs pyramid take their gradient
through the target gathered whole (``tests/test_torch_space_train.py``
holds AMT).

* one ``parallel.make_train_step`` step (L1, Adam 1e-4) of each at b1 x
  128x64 f64 on a ``(1, 2)`` mesh (two bands of 64 rows) against the same
  step on ``(1, 1)``: the loss within ``LOSS_RTOL`` relative, each gradient
  within ``GRAD_RTOL`` of its tensor's largest magnitude after 1e-12
  absolute. The splat sums in f32 in every dtype (as the kernel does), and
  the bands' partials add in another order than one device's sum, so the
  f64 split is one device's up to f32 rounding of the splats (EISAI's
  correlation dots are f32 too). Measured at 2 and 4 torch threads, the
  worst tensor's gap (tolerance ~4x): M2M loss 1.5e-11, gradient 9.8e-9
  (4e-8); XVFI 1.8e-11, 8.2e-10 (4e-9); GMFSS base 5.0e-13, 4.7e-7
  (2e-6); union 3.7e-13, 3.0e-7 (2e-6); EISAI 1.1e-10, 6.0e-7 (3e-6);
* M2M on a ``(2, 2)`` mesh at b2 (a sample per data shard, two bands
  each) against ``(1, 1)`` in f64: measured loss 9.7e-12, gradient 2.1e-7
  (tolerance 1e-6);
* M2M's split step in bf16 against the one-device f32 step: bf16 is as far
  from f32 split as on one device (measured at 128x64: the loss 3.3e-3
  relative in both; the gradients' gaps over their largest magnitudes a
  median 0.067 split, 0.066 on one device, the worst 0.55 and 0.55):
  held to the loss within 1e-2, the median within 0.1 and within 1.1x one
  device's bf16 median;
* the slice against JAX: M2M's f32 split step on ``(1, 2)`` against
  ``jax.value_and_grad`` of the JAX package's one-device M2M at the same
  b1 x 128x64 batch and weights (``tests/torch_train_cases.py``), at
  ``torch_train_cases``' tolerances: the loss within 1e-6 relative, each
  gradient within 5e-5 of its largest magnitude plus 1e-7 (measured: the
  loss 2.1e-7 apart, the worst gradient 1.0e-6 of its largest magnitude
  past the 1e-7). Not against JAX's own
  split step, which is wrong for M2M at 128 rows (``ROADMAP.md``, Queue 3).

``PYTHONPATH=.:tests python tests/test_torch_space_train_splat.py`` prints
the gaps. One JAX compile in this file: M2M's ``value_and_grad``.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_space_train_cases as sc
import torch_train_cases as tc
from comfyui_frame_interpolation_tpu.models import m2m as jm
from comfyui_frame_interpolation_tpu_torch.parallel import space
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

HW = (128, 64)
GRAD_ATOL = 1e-12
# (loss relative, each gradient over its tensor's largest magnitude)
TOLERANCES = {
    "m2m": (1e-10, 4e-8),
    "xvfi": (1e-10, 4e-9),
    "gmfss": (4e-12, 2e-6),
    "gmfss_union": (4e-12, 2e-6),
    "eisai": (5e-10, 3e-6),
}
MESH_2X2_TOL = (1e-10, 1e-6)
BF16_LOSS_RTOL, BF16_MEDIAN, BF16_MEDIAN_VS_ONE = 1e-2, 0.1, 1.1


def _gaps(name, mesh_shape=(1, 2), b=1):
    loss1, grads1 = sc.step(name, (1, 1), torch.float64, b, HW)
    loss2, grads2 = sc.step(name, mesh_shape, torch.float64, b, HW)
    return abs(loss2 - loss1) / abs(loss1), *sc.rel_gap(grads2, grads1, GRAD_ATOL)


@pytest.mark.parametrize("name", list(TOLERANCES))
def test_split_step_matches_one_device_in_f64(name, monkeypatch):
    partials = []
    real = space.softsplat_partial
    monkeypatch.setattr(space, "softsplat_partial", lambda *a: partials.append(a[2]) or real(*a))
    loss_gap, grad_gap, worst = _gaps(name)
    loss_rtol, grad_rtol = TOLERANCES[name]
    # every splat ran on the two bands, the second's sources from its own first row
    assert partials and partials[::2] == [0] * (len(partials) // 2) and all(a > 0 for a in partials[1::2])
    assert loss_gap <= loss_rtol, loss_gap
    assert grad_gap <= grad_rtol, (worst, grad_gap)


def test_m2m_on_a_2x2_mesh_matches_one_device_in_f64():
    loss_gap, grad_gap, worst = _gaps("m2m", (2, 2), 2)
    assert loss_gap <= MESH_2X2_TOL[0], loss_gap
    assert grad_gap <= MESH_2X2_TOL[1], (worst, grad_gap)


def _median_gap(got, ref):
    return float(np.median([float((got[k].double() - r.double()).abs().max()) / float(r.abs().max())
                            for k, r in ref.items() if float(r.abs().max()) > 0]))


def _bf16_gaps():
    loss32, grads32 = sc.step("m2m", (1, 1), torch.float32, 1, HW)
    out = {}
    for shape in ((1, 1), (1, 2)):
        loss, grads = sc.step("m2m", shape, torch.bfloat16, 1, HW)
        assert all(g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all()) for g in grads.values())
        out[shape] = (abs(loss - loss32) / loss32, _median_gap(grads, grads32))
    return out


def test_m2m_bf16_split_step_is_as_close_to_f32_as_one_device():
    gaps = _bf16_gaps()
    (loss_one, median_one), (loss_split, median_split) = gaps[(1, 1)], gaps[(1, 2)]
    assert loss_split <= BF16_LOSS_RTOL, loss_split
    assert median_split <= BF16_MEDIAN and median_split <= BF16_MEDIAN_VS_ONE * median_one, (median_split, median_one)


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads():
    f0, f1, t, target = (a.numpy().astype(np.float32) for a in sc.batch(1, HW, torch.float64))

    def apply(p, dtype):
        return jm.apply(p, jnp.asarray(f0, dtype), jnp.asarray(f1, dtype), jnp.asarray(t, dtype))

    return tc.jax_loss_and_grads(sc.params("m2m"), apply, target)


def _jax_gap():
    jloss, jgrads = _jax_loss_and_grads()
    module = sc.net("m2m", torch.float32)
    loss, grads = sc.step("m2m", (1, 2), torch.float32, 1, HW)
    ref = tc.jax_param_grads(module, jgrads)
    return loss, jloss, grads, ref


def test_m2m_split_step_matches_jax_one_device():
    loss, jloss, grads, ref = _jax_gap()
    assert len(ref) == len(grads) == 188
    np.testing.assert_allclose(loss, jloss, rtol=tc.LOSS_RTOL)
    tc.assert_grads_close(grads, ref)


if __name__ == "__main__":
    for threads in (2, 4):
        torch.set_num_threads(threads)
        for name in TOLERANCES:
            loss_gap, grad_gap, worst = _gaps(name)
            print(f"{threads} threads, {name}: loss {loss_gap:.3g}, gradient {grad_gap:.3g} at {worst}", flush=True)
        loss_gap, grad_gap, worst = _gaps("m2m", (2, 2), 2)
        print(f"{threads} threads, m2m (2, 2) b2: loss {loss_gap:.3g}, gradient {grad_gap:.3g} at {worst}", flush=True)
        for shape, (loss_gap, median) in _bf16_gaps().items():
            print(f"{threads} threads, m2m bf16 on {shape} against f32 one device: loss {loss_gap:.3g}, median gradient {median:.3g}")
        loss, jloss, grads, ref = _jax_gap()
        worst = max(tc.rel_errors(grads, ref).items(), key=lambda kv: kv[1])
        print(f"{threads} threads, m2m f32 split against JAX one device: loss {abs(loss - jloss) / abs(jloss):.3g}, "
              f"gradient {worst[1]:.3g} at {worst[0]}", flush=True)
