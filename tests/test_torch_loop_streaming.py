"""The port's streaming executors against its resident ones, on the CPU: the
mirror of ``tests/test_loop_streaming.py``. Over the memory budget every
executor streams, and the streamed result (a host tensor) must equal the
resident one bit for bit, for every plan shape: flat timestep (an int and a
list multiplier, with skips), recursive midpoint and bisection (produced
frames read by later levels, so their device buffers are released by
consumer counts), the 4-frame window (with doubled ends and skips) and the
pair cache; a 500-frame clip under a budget that holds 25 frames; and the
pair cache's copies in flight bounded by two chunks. The streamed run also
equals the JAX package's streaming executor on the same plan (within f32
rounding, 1e-6: the two blends are computed by two libraries).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from comfyui_frame_interpolation_tpu.core import loop as jloop
from comfyui_frame_interpolation_tpu.core import schedule as jsched
from comfyui_frame_interpolation_tpu_torch.core import loop
from comfyui_frame_interpolation_tpu_torch.core.loop import run_plan, run_plan_pair_cached, run_plan_window4
from comfyui_frame_interpolation_tpu_torch.core.schedule import (
    InterpolationStateList,
    plan_bisection,
    plan_midpoint,
    plan_timestep,
    plan_window4,
)
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)


def _blend(f0, f1, t):
    t = t[:, None, None, None]
    return f0 * (1.0 - t) + f1 * t + 0.01 * f0 * f1


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.random((9, 16, 24, 3)).astype(np.float32))


def _compare(frames, plan, batch_size):
    dense = run_plan(frames, plan, _blend, batch_size=batch_size)
    streamed = run_plan(frames, plan, _blend, batch_size=batch_size, memory_budget_bytes=1)
    assert streamed.device.type == "cpu"  # host-resident output
    torch.testing.assert_close(streamed, dense, rtol=0, atol=0)
    return streamed


def test_streaming_matches_dense_timestep(frames):
    _compare(frames, plan_timestep(len(frames), 4), batch_size=4)


def test_streaming_matches_dense_timestep_list(frames):
    _compare(frames, plan_timestep(len(frames), [3, 0, 2, 5, 1]), batch_size=3)


def test_streaming_matches_dense_with_skips(frames):
    states = InterpolationStateList([1, 4], is_skip_list=True)
    _compare(frames, plan_timestep(len(frames), 3, states), batch_size=4)


def test_streaming_matches_dense_midpoint(frames, monkeypatch):
    """A recursive plan: produced frames are read by later levels. Each
    device buffer is released once its last reader has run, and none is read
    after that (no host copy goes back)."""
    back = []
    real = loop._StreamOut.materialize

    def materialize(self, task_id):
        back.append(task_id)
        return real(self, task_id)

    monkeypatch.setattr(loop._StreamOut, "materialize", materialize)
    _compare(frames, plan_midpoint(len(frames), 8), batch_size=4)
    assert back == []


def test_streaming_matches_dense_bisection(frames):
    _compare(frames, plan_bisection(len(frames), 5), batch_size=4)


def test_resident_path_untouched_for_small_clips(frames, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("streamed a clip that fits")

    monkeypatch.setattr(loop, "_run_plan_streaming", refuse)
    out = run_plan(frames, plan_timestep(len(frames), 2), _blend, memory_budget_bytes=1 << 30)
    assert isinstance(out, torch.Tensor) and out.shape == (17, 16, 24, 3)
    out = run_plan(frames, plan_timestep(len(frames), 2), _blend)  # CPU frames, no budget: resident
    assert out.shape == (17, 16, 24, 3)


def _window_blend(f0, f1, f2, f3):
    # STMFNet-shaped interface: consume the full 4-frame window
    return 0.1 * f0 + 0.4 * f1 + 0.4 * f2 + 0.1 * f3


def test_window4_streaming_matches_dense(frames):
    for dup in (False, True):
        plan = plan_window4(len(frames), duplicate_first_last_frames=dup)
        dense = run_plan_window4(frames, plan, _window_blend, batch_size=3)
        streamed = run_plan_window4(frames, plan, _window_blend, batch_size=3, memory_budget_bytes=1)
        assert streamed.device.type == "cpu"
        torch.testing.assert_close(streamed, dense, rtol=0, atol=0)


def test_window4_streaming_with_skips(frames):
    states = InterpolationStateList([2, 3], is_skip_list=True)
    plan = plan_window4(len(frames), states=states)
    dense = run_plan_window4(frames, plan, _window_blend, batch_size=4)
    streamed = run_plan_window4(frames, plan, _window_blend, batch_size=4, memory_budget_bytes=1)
    torch.testing.assert_close(streamed, dense, rtol=0, atol=0)


def _reuse(f0, f1):
    # GMFSS-shaped interface: timestep-invariant per-pair state (e.g. flow)
    return {"flow": (f1 - f0) * 0.5, "metric": f0 * f1}


def _infer(f0, f1, cache, t):
    t = t[:, None, None, None]
    return f0 * (1.0 - t) + f1 * t + cache["flow"] * t + 0.01 * cache["metric"]


def test_pair_cached_streaming_matches_dense(frames):
    for mult in (4, [3, 0, 2, 5, 1, 2, 2, 2]):
        plan = plan_timestep(len(frames), mult)
        dense = run_plan_pair_cached(frames, plan, _reuse, _infer, batch_size=3)
        streamed = run_plan_pair_cached(frames, plan, _reuse, _infer, batch_size=3, memory_budget_bytes=1)
        assert streamed.device.type == "cpu"
        torch.testing.assert_close(streamed, dense, rtol=0, atol=0)


def test_long_clip_bounded_budget(monkeypatch):
    """A 500-frame clip through the window and pair-cached streaming
    executors under a budget that could never hold it resident (it admits
    25 frames of the ~1000-frame working set): the originals' LRU never holds
    more than 25 frames, and the results equal the resident runs."""
    rng = np.random.default_rng(11)
    clip = torch.from_numpy(rng.random((500, 8, 16, 3)).astype(np.float32))
    frame_bytes = 8 * 16 * 3 * 4
    budget = 100 * frame_bytes  # max_resident = budget // (4 * frame_bytes) = 25 frames
    peak = {"lru": 0}
    real_get = loop._OrigLRU.get

    def get(self, idx):
        arr = real_get(self, idx)
        peak["lru"] = max(peak["lru"], len(self.cache))
        assert self.max_resident == 25
        return arr

    monkeypatch.setattr(loop._OrigLRU, "get", get)

    plan = plan_window4(len(clip))
    out = run_plan_window4(clip, plan, _window_blend, batch_size=4, memory_budget_bytes=budget)
    assert out.device.type == "cpu" and len(out) == len(plan.output)
    torch.testing.assert_close(out, run_plan_window4(clip, plan, _window_blend, batch_size=4), rtol=0, atol=0)

    plan = plan_timestep(len(clip), 2)
    out = run_plan_pair_cached(clip, plan, _reuse, _infer, batch_size=8, memory_budget_bytes=budget)
    assert out.device.type == "cpu" and len(out) == len(plan.output)
    torch.testing.assert_close(out, run_plan_pair_cached(clip, plan, _reuse, _infer, batch_size=8), rtol=0, atol=0)
    assert 0 < peak["lru"] <= 25


def test_pair_cached_streaming_in_flight_bounded(monkeypatch, frames):
    """The pair-cached streaming executor lands copies inside the per-pair
    timestep loop: a multiplier-m pair would otherwise hold m * batch device
    buffers."""
    peak = {"v": 0}
    orig_add = loop._StreamOut.add

    def add(self, tid, arr):
        orig_add(self, tid, arr)
        peak["v"] = max(peak["v"], len(self.in_flight))

    monkeypatch.setattr(loop._StreamOut, "add", add)
    batch = 2
    plan = plan_timestep(len(frames), 50)  # 49 timesteps per pair
    out = run_plan_pair_cached(frames, plan, _reuse, _infer, batch_size=batch, memory_budget_bytes=1)
    assert out.device.type == "cpu" and len(out) == len(plan.output)
    # keep_last=batch in flight + one freshly-added chunk
    assert peak["v"] <= 2 * batch, peak["v"]


@jax.jit
def _jax_blend(f0, f1, t):
    t = t[:, None, None, None]
    return f0 * (1.0 - t) + f1 * t + 0.01 * f0 * f1


@pytest.mark.parametrize("planner,args,batch", [("plan_midpoint", (9, 8), 4), ("plan_bisection", (9, 5), 3)])
def test_streaming_matches_jax_streaming(frames, planner, args, batch):
    ref = jloop.run_plan(frames.numpy(), getattr(jsched, planner)(*args), _jax_blend, batch_size=batch, hbm_budget_bytes=1)
    assert isinstance(ref, np.ndarray)
    got = run_plan(frames, globals()[planner](*args), _blend, batch_size=batch, memory_budget_bytes=1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
