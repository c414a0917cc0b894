"""The port's forward splat (plain twin ``softsplat_torch``, which CPU tensors
take through ``softsplat_func``) against the JAX package's exact scatter
``_softsplat_xla`` and the loop oracle of ``tests/test_ops_custom.py``, on
the CPU.

The oracle is ``_softsplat_xla``, not the Pallas kernel, which carries about
1e-3 of MXU error. Tolerance: f32 atol 1e-5 on values in [0, 1] (the twin sums
the same products in f32; only the order of duplicate-target sums may
differ, each pixel taking at most a few dozen contributions).

The mode wrappers ``softsplat`` (every mode and eps variant) and
``function_softsplat`` (every legacy name and short alias) against the JAX
package's, f32 atol 1e-5, on a flow that leaves target pixels empty (exact
zero normalisers) and a metric with zeros.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import warp_cases
from comfyui_frame_interpolation_tpu.ops.softsplat import _softsplat_xla
from comfyui_frame_interpolation_tpu_torch.ops.softsplat import softsplat_func, softsplat_torch
from test_ops_custom import softsplat_oracle
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

ATOL = 1e-5
CASES = warp_cases.splat_cases(0, 64, 128)


def _jax_splat(vals, flow):
    return np.asarray(_softsplat_xla(jnp.asarray(vals), jnp.asarray(flow)))


def _dropped(flow):
    """The flow with every source whose target is beyond +-1e6 px made
    non-finite: what the JAX path is given to express "drop" for the huge
    case (its int32 conversion of a 1e30 coordinate is not defined)."""
    f = flow.copy()
    f[np.abs(f).max(-1) > 1e6] = np.inf
    return f


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_twin_matches_jax_scatter(name):
    case = next(c for c in CASES if c["name"] == name)
    vals, flow = case["vals"], case["flow"]
    got = softsplat_func(torch.from_numpy(vals), torch.from_numpy(flow))
    assert got.dtype == torch.float32 and tuple(got.shape) == vals.shape
    np.testing.assert_allclose(got.numpy(), _jax_splat(vals, _dropped(flow)), atol=ATOL, rtol=0)


def test_twin_matches_loop_oracle():
    rng = np.random.default_rng(42)
    x = rng.standard_normal((2, 7, 9, 3)).astype(np.float32)
    flow = (rng.standard_normal((2, 7, 9, 2)) * 3).astype(np.float32)
    flow[0, 1, 1, 0] = np.nan
    flow[1, 2, 2, 1] = np.inf
    got = softsplat_torch(torch.from_numpy(x), torch.from_numpy(flow)).numpy()
    np.testing.assert_allclose(got, softsplat_oracle(x, flow), atol=ATOL, rtol=0)


def test_nonfinite_and_huge_flow_drop_the_source():
    vals = np.ones((1, 6, 8, 2), np.float32)
    flow = np.zeros((1, 6, 8, 2), np.float32)
    for (y, x), f in zip(((1, 1), (2, 3), (3, 5), (4, 2), (5, 7)), ((np.nan, 0), (0, np.inf), (1e30, 0), (0, -1e30), (-1e30, 1e30))):
        flow[0, y, x] = f
    got = softsplat_torch(torch.from_numpy(vals), torch.from_numpy(flow)).numpy()
    expect = np.ones_like(vals)
    for y, x in ((1, 1), (2, 3), (3, 5), (4, 2), (5, 7)):
        expect[0, y, x] = 0.0
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_low_precision_sums_in_f32_and_casts_once(dtype):
    case = CASES[2]
    vals = torch.from_numpy(case["vals"]).to(dtype)
    got = softsplat_torch(vals, torch.from_numpy(case["flow"]))
    ref = softsplat_torch(vals.float(), torch.from_numpy(case["flow"])).to(dtype)
    assert got.dtype == dtype
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_dispatch_raises_off_cpu_and_cuda():
    vals = torch.zeros(1, 4, 4, 2, device="meta")
    flow = torch.zeros(1, 4, 4, 2, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        softsplat_func(vals, flow)
    with pytest.raises(ValueError, match="cuda or cpu"):
        softsplat_func(torch.zeros(1, 4, 4, 2), flow)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never falls back to the twin: CPU tensors raise
    before anything is built."""
    from comfyui_frame_interpolation_tpu_torch.ops.cuda.softsplat_kernel import softsplat_bilinear

    with pytest.raises(ValueError, match="CUDA tensors"):
        softsplat_bilinear(torch.zeros(1, 2, 4, 4), torch.zeros(1, 2, 4, 4))


# ---- the mode wrappers --------------------------------------------------------

MODES = [f"{base}{eps}" for base in ("avg", "linear", "soft") for eps in ("", "-addeps", "-zeroeps", "-clipeps")]


def _wrapper_inputs():
    """Values, a flow that leaves an empty strip (exact-zero normalisers)
    and shifts the rest sub-pixel, and a metric with negative and zero
    entries."""
    rng = np.random.default_rng(3)
    vals = rng.random((2, 16, 24, 3), dtype=np.float32)
    flow = (rng.standard_normal((2, 16, 24, 2)) * 0.7).astype(np.float32)
    flow[..., 0] += 4.0
    metric = rng.standard_normal((2, 16, 24, 1)).astype(np.float32)
    metric[:, ::5] = 0.0
    return vals, flow, metric


@pytest.mark.parametrize("mode", ["sum"] + MODES)
def test_softsplat_modes_match_jax(mode):
    from comfyui_frame_interpolation_tpu.ops.softsplat import softsplat as jax_softsplat
    from comfyui_frame_interpolation_tpu_torch.ops.softsplat import softsplat

    vals, flow, metric = _wrapper_inputs()
    m = None if mode.split("-")[0] in ("sum", "avg") else metric
    ref = np.asarray(jax_softsplat(jnp.asarray(vals), jnp.asarray(flow), None if m is None else jnp.asarray(m), mode))
    got = softsplat(torch.from_numpy(vals), torch.from_numpy(flow), None if m is None else torch.from_numpy(m), mode)
    assert got.dtype == torch.float32 and tuple(got.shape) == vals.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["summation", "average", "linear", "softmax", "sum", "avg", "soft"])
def test_function_softsplat_names_match_jax(name):
    from comfyui_frame_interpolation_tpu.ops.softsplat import function_softsplat as jax_function_softsplat
    from comfyui_frame_interpolation_tpu_torch.ops.softsplat import function_softsplat

    vals, flow, metric = _wrapper_inputs()
    ref = np.asarray(jax_function_softsplat(jnp.asarray(vals), jnp.asarray(flow), jnp.asarray(metric), name))
    got = function_softsplat(torch.from_numpy(vals), torch.from_numpy(flow), torch.from_numpy(metric), name)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)


def test_softsplat_rejects_unknown_modes_and_metrics():
    from comfyui_frame_interpolation_tpu_torch.ops.softsplat import function_softsplat, softsplat

    vals, flow, metric = (torch.from_numpy(a) for a in _wrapper_inputs())
    for mode, m in (("max", None), ("soft-noeps", metric), ("soft", None), ("sum", metric)):
        with pytest.raises(ValueError):
            softsplat(vals, flow, m, mode)
    with pytest.raises(ValueError):
        function_softsplat(vals, flow, metric, "maximum")
