"""K2's library yardstick on the CPU: ``utils.kernel_compare.library_splat``
(one ``aten.grid_sampler_2d_backward`` call on a precomputed grid, whose
input gradient is the sum splat of the values at the grid's targets)
against the port's plain splat, ``ops.softsplat.softsplat_torch``, and the
JAX package's ``_softsplat_xla`` (the splat in sum mode), on the splat cases
of ``tests/warp_cases.py`` at 32x64, f32.

The call is timed beside K2 on the card (``chip_smoke.py``) and never runs
in the port; this holds it to the same function. Tolerance: 3e-5 of the
case's largest output plus 1e-6. The grid is normalised to [-1, 1] and the
call maps it back, so each target moves by up to two f32 ulps of its
coordinate (up to 2w = 128 px here), and each weight by as much; summed over
the sources that share a corner this stays below 1e-5 of the largest output
on every case. JAX is given the sources whose targets lie beyond +-1e6 px
as non-finite, as the splat's other tests do (its int32 conversion of such
a coordinate is not defined; the grid, like the twin, clamps them off the
frame).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import warp_cases
from comfyui_frame_interpolation_tpu.ops.softsplat import _softsplat_xla
from comfyui_frame_interpolation_tpu_torch.ops.softsplat import softsplat_torch
from comfyui_frame_interpolation_tpu_torch.utils.kernel_compare import library_splat
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)

RTOL_OF_MAX = 3e-5
ATOL = 1e-6

CASES = {c["name"]: c for c in warp_cases.splat_cases(0, 32, 64)}


@pytest.mark.parametrize("name", list(CASES))
def test_library_splat_matches_twin_and_jax(name):
    case = CASES[name]
    vals, flow = torch.from_numpy(case["vals"]), torch.from_numpy(case["flow"])
    got = library_splat(vals, flow)()
    assert got.shape == vals.permute(0, 3, 1, 2).shape and got.dtype == torch.float32
    got = got.permute(0, 2, 3, 1).numpy()
    twin = softsplat_torch(vals, flow).numpy()
    dropped = case["flow"].copy()
    dropped[np.abs(dropped).max(-1) > 1e6] = np.inf
    ref = np.asarray(_softsplat_xla(jnp.asarray(case["vals"]), jnp.asarray(dropped)))
    for other in (twin, ref):
        np.testing.assert_allclose(got, other, rtol=0, atol=RTOL_OF_MAX * float(np.abs(other).max(initial=0.0)) + ATOL)
