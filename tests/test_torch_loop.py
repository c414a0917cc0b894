"""The port's resident plan executor against the JAX package's ``run_plan``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.core import loop as jloop
from comfyui_frame_interpolation_tpu.core import schedule as jsched
from comfyui_frame_interpolation_tpu_torch.core import loop as ploop
from comfyui_frame_interpolation_tpu_torch.core import schedule as psched


def _jax_model(f0, f1, t):
    return f0 * 0.25 + f1 * 0.5 + t[:, None, None, None]


def _port_model(f0, f1, t):
    return f0 * 0.25 + f1 * 0.5 + t[:, None, None, None]


@pytest.mark.parametrize(
    "planner,args,batch",
    [
        ("plan_timestep", (5, 3), 2),
        ("plan_timestep", (4, [2, 0, 4]), 3),
        ("plan_midpoint", (3, 5), 2),
        ("plan_bisection", (3, [4, 3]), 4),
    ],
)
def test_run_plan_matches_jax(planner, args, batch):
    frames = np.random.default_rng(0).random((args[0], 4, 6, 3), dtype=np.float32)
    ref = jloop.run_plan(jnp.asarray(frames), getattr(jsched, planner)(*args), _jax_model, batch_size=batch)
    got = ploop.run_plan(torch.from_numpy(frames), getattr(psched, planner)(*args), _port_model, batch_size=batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


def test_run_plan_pads_every_call_to_batch_size():
    frames = torch.rand(4, 2, 2, 3)
    widths = []

    def model(f0, f1, t):
        widths.append((f0.shape[0], f1.shape[0], t.shape[0]))
        return (f0 + f1) / 2

    out = ploop.run_plan(frames, psched.plan_timestep(4, 2), model, batch_size=2, out_dtype=torch.float64)
    assert widths == [(2, 2, 2), (2, 2, 2)]
    assert out.dtype == torch.float64 and out.shape == (7, 2, 2, 3)


def test_run_plan_over_budget_raises():
    frames = torch.zeros(3, 8, 8, 3)
    plan = psched.plan_timestep(3, 2)
    frame_bytes = 8 * 8 * 3 * 4
    with pytest.raises(MemoryError, match="streaming"):
        ploop.run_plan(frames, plan, _port_model, batch_size=2, memory_budget_bytes=10 * frame_bytes)
    out = ploop.run_plan(frames, plan, _port_model, batch_size=2, memory_budget_bytes=16 * frame_bytes)
    assert out.shape == (5, 8, 8, 3)
