"""The splat's gradient in the port against the JAX package's, on the CPU.

``ops.softsplat.softsplat_backward_torch`` (``torch.autograd.grad`` through
the plain twin, the backward kernel's plain version) against ``jax.vjp`` of
``comfyui_frame_interpolation_tpu.ops.softsplat._softsplat_xla``, which is
the gradient the JAX package trains with (XLA's VJP of the scatter-add; no
Pallas kernel has a backward), on the same numpy inputs and the same output
gradient, f32 only (``_softsplat_xla`` builds its grid and sums in the
input's dtype):

* the splat cases of ``tests/warp_cases.py`` at 32x64 (C = 1, 2, 4, 8, 66;
  smooth, constant and diagonal displacements, piles, rough, non-finite and
  huge flow), and the backward kernel's own (``splat_backward_cases``: C =
  3, 5, 8, 65, integer and half-pixel constant offsets, targets exactly on
  and just off each bound, where the flow's gradient is one-sided);
* C = 1 to 8 and 65 on one flow, each width the kernel's lane groups and
  channel tails meet;
* the huge case: ``_softsplat_xla``'s int32 conversion of a 1e30
  coordinate is not defined, so JAX is given those sources as non-finite
  (both drop them; the port clamps and passes no gradient), as the forward
  tests do;
* the gradients of every ``softsplat`` mode and eps variant (values, flow
  and metric) and of every legacy ``function_softsplat`` name, against
  ``jax.vjp`` of the JAX package's functions.

Tolerances, on values in [0, 1] and output gradients in [-1, 1]: the
input's gradient within 2e-6 (at most four products summed in another
order); the flow's within 1e-5 of the largest magnitude of its case plus
1e-6 (a sum over up to 66 channels' products in another order). The mode
wrappers divide by the splatted normaliser, down to 1e-7 for ``addeps``
where only zero metrics land, which scales some gradients by 1e7: each of
their gradients is held within 1e-5 of its largest magnitude plus 1e-6.
Measured on the cases: the input's gradient bit for bit, the flow's within
1.7e-7 of its case's largest magnitude.

On the card the backward kernel is held to this plain version in
``tests/test_torch_cuda_softsplat.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import warp_cases
from comfyui_frame_interpolation_tpu.ops.softsplat import _softsplat_xla
from comfyui_frame_interpolation_tpu.ops.softsplat import function_softsplat as jax_function_softsplat
from comfyui_frame_interpolation_tpu.ops.softsplat import softsplat as jax_softsplat
from comfyui_frame_interpolation_tpu_torch.ops.cuda import softsplat_kernel
from comfyui_frame_interpolation_tpu_torch.ops.softsplat import (
    function_softsplat, softsplat, softsplat_backward_torch, softsplat_func, softsplat_torch,
)
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

IN_ATOL = 2e-6
FLOW_RTOL = 1e-5
FLOW_ATOL = 1e-6

CASES = {c["name"]: c for c in warp_cases.splat_cases(0, 32, 64) + warp_cases.splat_backward_cases(1, 32, 64)}


def _out_grad(shape, seed):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, shape).astype(np.float32)


def _dropped(flow):
    """The flow with every source whose target is beyond +-1e6 px made
    non-finite, for the JAX side (see the module docstring)."""
    f = flow.copy()
    f[np.abs(f).max(-1) > 1e6] = np.inf
    return f


def _jax_grads(vals, flow, g):
    _, vjp = jax.vjp(_softsplat_xla, jnp.asarray(vals), jnp.asarray(_dropped(flow)))
    gi, gf = vjp(jnp.asarray(g))
    return np.asarray(gi), np.asarray(gf)


def _compare(vals, flow, seed=0):
    g = _out_grad(vals.shape, seed)
    ref_i, ref_f = _jax_grads(vals, flow, g)
    got_i, got_f = (t.numpy() for t in softsplat_backward_torch(torch.from_numpy(vals), torch.from_numpy(flow), torch.from_numpy(g)))
    assert got_i.shape == vals.shape and got_f.shape == flow.shape
    assert np.isfinite(got_i).all() and np.isfinite(got_f).all()
    np.testing.assert_allclose(got_i, ref_i, atol=IN_ATOL, rtol=0)
    scale = float(np.abs(ref_f).max(initial=0.0))
    np.testing.assert_allclose(got_f, ref_f, atol=FLOW_RTOL * scale + FLOW_ATOL, rtol=0)
    return got_i, got_f


@pytest.mark.parametrize("name", list(CASES))
def test_backward_matches_jax_vjp(name):
    case = CASES[name]
    _compare(case["vals"], case["flow"])


@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 6, 7, 8, 65])
def test_backward_widths_match_jax_vjp(c):
    rng = np.random.default_rng(c)
    vals = rng.random((2, 32, 64, c), dtype=np.float32)
    flow = warp_cases.smooth_flow(2, 32, 64, 5.0, scale=12.0) + rng.standard_normal((2, 32, 64, 2)).astype(np.float32)
    _compare(vals, flow, seed=c)


def test_dropped_sources_pass_no_gradient():
    """A source with a non-finite or huge (clamped) target, or whose corners
    all leave the frame, gets zero gradients; a source exactly on x = -1
    keeps its x1 corner (weight 0) and gets the one-sided flow gradient."""
    h, w = 6, 8
    vals = np.random.default_rng(3).random((1, h, w, 2), dtype=np.float32)
    flow = np.zeros((1, h, w, 2), np.float32)
    dropped = {(1, 1): (np.nan, 0.0), (2, 3): (0.0, np.inf), (3, 5): (1e30, 0.0), (4, 2): (0.0, -1e30), (5, 7): (5.0, 0.0)}
    for (y, x), f in dropped.items():
        flow[0, y, x] = f
    flow[0, 0, 4] = (-5.0, 0.0)  # target x = -1, y = 0: only (0, 0) kept, weight 0
    g = _out_grad(vals.shape, 3)
    gi, gf = (t.numpy() for t in softsplat_backward_torch(torch.from_numpy(vals), torch.from_numpy(flow), torch.from_numpy(g)))
    for y, x in dropped:
        assert np.all(gi[0, y, x] == 0.0) and np.all(gf[0, y, x] == 0.0)
    assert np.all(gi[0, 0, 4] == 0.0)
    # d/dfx of the kept corner's weight wx1 = fx - floor(fx) is 1: the sum of in * g at (0, 0)
    np.testing.assert_allclose(gf[0, 0, 4, 0], (vals[0, 0, 4] * g[0, 0, 0]).sum(), rtol=1e-6)
    ref_i, ref_f = _jax_grads(vals, flow, g)
    np.testing.assert_allclose(gi, ref_i, atol=IN_ATOL, rtol=0)
    np.testing.assert_allclose(gf, ref_f, atol=FLOW_ATOL, rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_low_precision_sums_in_f32_and_casts_once(dtype):
    case = CASES["splat_bwd_c5"]
    vals = torch.from_numpy(case["vals"]).to(dtype)
    flow = torch.from_numpy(case["flow"]).to(dtype)
    g = torch.from_numpy(_out_grad(vals.shape, 4))
    gi, gf = softsplat_backward_torch(vals, flow, g)
    ri, rf = softsplat_backward_torch(vals.float(), flow.float(), g)
    assert gi.dtype == gf.dtype == dtype
    torch.testing.assert_close(gi, ri.to(dtype), rtol=0, atol=0)
    torch.testing.assert_close(gf, rf.to(dtype), rtol=0, atol=0)


def test_cpu_autograd_through_splat_takes_the_twin():
    """``softsplat_func`` on CPU tensors that need a gradient differentiates
    the twin: no kernel wrapper is reached and the gradients equal the plain
    version's."""
    case = CASES["smooth_amp8_c4"]
    vals = torch.from_numpy(case["vals"]).requires_grad_()
    flow = torch.from_numpy(case["flow"]).requires_grad_()
    g = torch.from_numpy(_out_grad(case["vals"].shape, 2))
    before = (softsplat_kernel.launches, softsplat_kernel.backward_launches)
    gi, gf = torch.autograd.grad(softsplat_func(vals, flow), (vals, flow), g)
    ri, rf = softsplat_backward_torch(vals, flow, g)
    assert (softsplat_kernel.launches, softsplat_kernel.backward_launches) == before
    torch.testing.assert_close(gi, ri, rtol=0, atol=0)
    torch.testing.assert_close(gf, rf, rtol=0, atol=0)


def test_backward_wrapper_refuses_cpu_tensors():
    """The backward kernel's wrapper never falls back to the plain version:
    CPU tensors raise before anything is built."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        softsplat_kernel.softsplat_bilinear_backward(torch.zeros(1, 2, 4, 4), torch.zeros(1, 2, 4, 4), torch.zeros(1, 2, 4, 4))


# ---- the mode wrappers --------------------------------------------------------

MODES = ["sum"] + [f"{base}{eps}" for base in ("avg", "linear", "soft") for eps in ("", "-addeps", "-zeroeps", "-clipeps")]
LEGACY = ["summation", "average", "linear", "softmax", "sum", "avg", "soft"]


def _wrapper_inputs():
    """Values, a flow that leaves an empty strip (exact-zero normalisers)
    and shifts the rest sub-pixel, a metric with negative and zero entries,
    and an output gradient."""
    rng = np.random.default_rng(3)
    vals = rng.random((2, 16, 24, 3), dtype=np.float32)
    flow = (rng.standard_normal((2, 16, 24, 2)) * 0.7).astype(np.float32)
    flow[..., 0] += 4.0
    metric = rng.standard_normal((2, 16, 24, 1)).astype(np.float32)
    metric[:, ::5] = 0.0
    return vals, flow, metric, _out_grad(vals.shape, 6)


def _wrapper_grads_close(jax_fn, port_fn, takes_metric):
    vals, flow, metric, g = _wrapper_inputs()
    args = (vals, flow, metric) if takes_metric else (vals, flow)
    _, vjp = jax.vjp(lambda *a: jax_fn(*a) if takes_metric else jax_fn(*a, None), *(jnp.asarray(a) for a in args))
    ref = [np.asarray(r) for r in vjp(jnp.asarray(g))]
    tens = [torch.from_numpy(a).requires_grad_() for a in args]
    out = port_fn(*tens) if takes_metric else port_fn(*tens, None)
    got = [t.numpy() for t in torch.autograd.grad(out, tens, torch.from_numpy(g))]
    for name, r, o in zip(("values", "flow", "metric"), ref, got):
        assert np.isfinite(o).all(), name
        scale = float(np.abs(r).max())
        assert scale > 0.0, name
        np.testing.assert_allclose(o, r, atol=FLOW_RTOL * scale + FLOW_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("mode", MODES)
def test_softsplat_mode_gradients_match_jax(mode):
    takes_metric = mode.split("-")[0] in ("linear", "soft")
    _wrapper_grads_close(
        lambda v, f, m: jax_softsplat(v, f, m, mode), lambda v, f, m: softsplat(v, f, m, mode), takes_metric
    )


@pytest.mark.parametrize("name", LEGACY)
def test_function_softsplat_gradients_match_jax(name):
    takes_metric = name in ("linear", "softmax", "soft")
    _wrapper_grads_close(
        lambda v, f, m: jax_function_softsplat(v, f, m, name),
        lambda v, f, m: function_softsplat(v, f, m, name),
        takes_metric,
    )
