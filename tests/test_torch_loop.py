"""The port's plan executors against the JAX package's ``run_plan``,
``run_plan_pair_cached`` and ``run_plan_window4``; over the memory budget
each streams and gives the resident result (the streaming executors are
held to the resident ones at length in ``tests/test_torch_loop_streaming.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.core import loop as jloop
from comfyui_frame_interpolation_tpu.core import schedule as jsched
from comfyui_frame_interpolation_tpu_torch.core import loop as ploop
from comfyui_frame_interpolation_tpu_torch.core import schedule as psched
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)


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


def _spy(monkeypatch, name):
    """Record each call of the executor function ``loop.<name>``."""
    seen, real = [], getattr(ploop, name)

    def spy(*args, **kwargs):
        seen.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(ploop, name, spy)
    return seen


def test_run_plan_over_budget_raises(monkeypatch):
    """Once the resident estimate is over the budget the clip streams (it
    used to raise): the result comes back on the host, equal to the resident
    one; at the budget it runs resident."""
    frames = torch.rand(3, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    plan = psched.plan_timestep(3, 2)
    frame_bytes = 8 * 8 * 3 * 4
    streaming = _spy(monkeypatch, "_run_plan_streaming")
    resident = ploop.run_plan(frames, plan, _port_model, batch_size=2)
    streamed = ploop.run_plan(frames, plan, _port_model, batch_size=2, memory_budget_bytes=10 * frame_bytes)
    assert streaming == ["_run_plan_streaming"]
    assert streamed.device.type == "cpu" and streamed.shape == (5, 8, 8, 3)
    torch.testing.assert_close(streamed, resident, rtol=0, atol=0)
    out = ploop.run_plan(frames, plan, _port_model, batch_size=2, memory_budget_bytes=16 * frame_bytes)
    assert len(streaming) == 1
    torch.testing.assert_close(out, resident, rtol=0, atol=0)


def _pair_fns():
    """A split model (reuse independent of t) for either package, counting
    its calls: ``(reuse_fn, infer_fn, calls)``."""
    calls = {"reuse": [], "infer": []}

    def reuse_fn(f0, f1):
        calls["reuse"].append(f0.shape[0])
        return {"a": f0 * 0.25, "b": f1 * 0.5}

    def infer_fn(f0, f1, cache, t):
        calls["infer"].append(np.asarray(t).tolist())
        return cache["a"] + cache["b"] + t[:, None, None, None]

    return reuse_fn, infer_fn, calls


@pytest.mark.parametrize(
    "mult,skip",
    [(2, None), (4, [1]), ([2, 3, 4], None), (3, None)],
)
def test_run_plan_pair_cached_matches_jax(mult, skip):
    """The plans of ``tests/test_schedule.py:237-262``, list mode included:
    the same outputs, reuse calls, padding and timestep order."""
    frames = np.arange(4 * 2 * 3 * 1, dtype=np.float32).reshape(4, 2, 3, 1)
    jplan = jsched.plan_timestep(4, mult, None if skip is None else jsched.InterpolationStateList(skip, True))
    pplan = psched.plan_timestep(4, mult, None if skip is None else psched.InterpolationStateList(skip, True))
    jr, ji, jcalls = _pair_fns()
    pr, pi, pcalls = _pair_fns()
    ref = jloop.run_plan_pair_cached(jnp.asarray(frames), jplan, jr, ji, batch_size=2)
    got = ploop.run_plan_pair_cached(torch.from_numpy(frames), pplan, pr, pi, batch_size=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert pcalls == jcalls
    # and the per-task executor agrees, as in the JAX package's own test
    np.testing.assert_allclose(got.numpy(), ploop.run_plan(torch.from_numpy(frames), pplan, _port_model, batch_size=2).numpy(), atol=1e-6)


def test_run_plan_pair_cached_over_budget_raises(monkeypatch):
    """Over the budget the pair-cached executor streams (it used to raise),
    with the resident result and the same calls."""
    frames = torch.rand(3, 8, 8, 3, generator=torch.Generator().manual_seed(1))
    plan = psched.plan_timestep(3, 3)
    frame_bytes = 8 * 8 * 3 * 4
    reuse_fn, infer_fn, calls = _pair_fns()
    streaming = _spy(monkeypatch, "_run_plan_pair_cached_streaming")
    resident = ploop.run_plan_pair_cached(frames, plan, reuse_fn, infer_fn, batch_size=2)
    resident_calls = {k: list(v) for k, v in calls.items()}
    calls["reuse"].clear(), calls["infer"].clear()
    streamed = ploop.run_plan_pair_cached(frames, plan, reuse_fn, infer_fn, batch_size=2, memory_budget_bytes=10 * frame_bytes)
    assert streaming == ["_run_plan_pair_cached_streaming"]
    assert streamed.shape == (7, 8, 8, 3) and calls == resident_calls
    torch.testing.assert_close(streamed, resident, rtol=0, atol=0)
    out = ploop.run_plan_pair_cached(frames, plan, reuse_fn, infer_fn, batch_size=2, memory_budget_bytes=20 * frame_bytes)
    assert len(streaming) == 1
    torch.testing.assert_close(out, resident, rtol=0, atol=0)


def test_run_plan_pair_cached_refuses_nested_plans():
    frames = torch.zeros(3, 2, 2, 3)
    reuse_fn, infer_fn, _ = _pair_fns()
    with pytest.raises(ValueError, match="flat"):
        ploop.run_plan_pair_cached(frames, psched.plan_midpoint(3, 4), reuse_fn, infer_fn, batch_size=2)


def _window_fn(calls):
    """A window-4 model for either package (the blend of
    ``tests/test_loop_streaming.py``), recording each call's window starts
    (read off frame 0's first value)."""

    def model_fn(f0, f1, f2, f3):
        calls.append(np.asarray(f0[:, 0, 0, 0]).tolist())
        return 0.1 * f0 + 0.4 * f1 + 0.4 * f2 + 0.1 * f3

    return model_fn


@pytest.mark.parametrize(
    "n,dup,skip,batch",
    [(7, False, None, 3), (7, True, None, 3), (8, False, [2, 3], 4), (6, True, [0, 1, 4], 2), (5, False, None, 4)],
)
def test_run_plan_window4_matches_jax(n, dup, skip, batch):
    """Plans with doubled first and last frames and with skipped pairs (a
    window is skipped when both of its first pairs are), at batch sizes that
    leave a short last chunk: the same outputs, calls and padding."""
    frames = np.random.default_rng(n).random((n, 4, 6, 3), dtype=np.float32)
    frames[:, 0, 0, 0] = np.arange(n)  # each frame names itself
    jstates = None if skip is None else jsched.InterpolationStateList(skip, True)
    pstates = None if skip is None else psched.InterpolationStateList(skip, True)
    jcalls, pcalls = [], []
    ref = jloop.run_plan_window4(jnp.asarray(frames), jsched.plan_window4(n, dup, jstates), _window_fn(jcalls), batch_size=batch)
    got = ploop.run_plan_window4(torch.from_numpy(frames), psched.plan_window4(n, dup, pstates), _window_fn(pcalls), batch_size=batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)
    assert pcalls == jcalls and all(len(c) == batch for c in pcalls)


def test_run_plan_window4_over_budget_raises(monkeypatch):
    """Over the budget the window-4 executor streams (it used to raise),
    with the resident result and the same windows per call."""
    frames = torch.rand(5, 8, 8, 3, generator=torch.Generator().manual_seed(2))
    frames[:, 0, 0, 0] = torch.arange(5.0)  # each frame names itself
    plan = psched.plan_window4(5)
    frame_bytes = 8 * 8 * 3 * 4
    resident_calls, streamed_calls = [], []
    streaming = _spy(monkeypatch, "_run_plan_window4_streaming")
    resident = ploop.run_plan_window4(frames, plan, _window_fn(resident_calls), batch_size=2)
    # 5 inputs + 7 outputs + 5 frames per window of a batch of 2
    streamed = ploop.run_plan_window4(frames, plan, _window_fn(streamed_calls), batch_size=2, memory_budget_bytes=21 * frame_bytes)
    assert streaming == ["_run_plan_window4_streaming"]
    assert streamed.shape == (7, 8, 8, 3) and streamed_calls == resident_calls
    torch.testing.assert_close(streamed, resident, rtol=0, atol=0)
    out = ploop.run_plan_window4(frames, plan, _window_fn([]), batch_size=2, memory_budget_bytes=22 * frame_bytes)
    assert len(streaming) == 1
    torch.testing.assert_close(out, resident, rtol=0, atol=0)
