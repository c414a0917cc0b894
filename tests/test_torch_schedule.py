"""The port's schedule planner equals the JAX package's, task by task, on
every plan that ``tests/test_schedule.py`` builds."""

import dataclasses

import pytest

from comfyui_frame_interpolation_tpu.core import schedule as jax_schedule
from comfyui_frame_interpolation_tpu_torch.core import schedule as port_schedule
from torch_threads import few_torch_threads  # noqa: F401  (autouse: caps torch's threads under xdist)


def _states(mod, indices, skip):
    return mod.InterpolationStateList(indices, is_skip_list=skip)


# (planner, positional args, states (indices, is_skip_list) or None, kwargs)
PLANS = [
    ("plan_timestep", (3, 2), None, {}),
    ("plan_timestep", (2, 4), None, {}),
    ("plan_timestep", (3, 1), None, {}),
    ("plan_timestep", (4, 2), ([1], True), {}),
    ("plan_timestep", (4, 2), ([1], False), {}),
    ("plan_timestep", (4, [3]), None, {}),
    ("plan_timestep", (4, [2, 0, 2]), None, {}),
    ("plan_timestep", (3, [2, 0]), None, {}),
    ("plan_timestep", (3, [1, 2]), None, {}),
    ("plan_timestep", (4, [2, 0, 2]), None, {"zero_drops_pair": False}),
    ("plan_timestep", (4, 4), ([1], True), {}),
    ("plan_timestep", (4, [2, 3, 4]), None, {}),
    ("plan_midpoint", (2, 2), None, {}),
    ("plan_midpoint", (2, 4), None, {}),
    ("plan_midpoint", (2, 3), None, {}),
    ("plan_midpoint", (2, 5), None, {}),
    ("plan_midpoint", (3, 2), ([0], True), {}),
    ("plan_bisection", (2, 2), None, {}),
    ("plan_bisection", (2, 4), None, {}),
    ("plan_bisection", (2, 3), None, {}),
    ("plan_bisection", (3, 2), ([0], True), {}),
    ("plan_bisection", (3, [2, 3]), None, {}),
    ("plan_window4", (4,), None, {}),
    ("plan_window4", (6,), None, {}),
    ("plan_window4", (4,), None, {"duplicate_first_last_frames": True}),
    ("plan_window4", (5,), ([0], True), {}),
    ("plan_window4", (5,), ([0, 1], True), {}),
]


def _build(mod, planner, args, states, kwargs):
    if states is not None:
        kwargs = dict(kwargs, states=_states(mod, *states))
    return getattr(mod, planner)(*args, **kwargs)


@pytest.mark.parametrize("planner,args,states,kwargs", PLANS)
def test_plan_equals_jax(planner, args, states, kwargs):
    ref = _build(jax_schedule, planner, args, states, kwargs)
    got = _build(port_schedule, planner, args, states, kwargs)
    assert got.n_frames == ref.n_frames
    assert [dataclasses.astuple(t) for t in got.tasks] == [
        dataclasses.astuple(t) for t in ref.tasks
    ]
    assert got.output == ref.output
    assert [[t.id for t in lv] for lv in got.levels] == [[t.id for t in lv] for lv in ref.levels]


def test_helpers_equal_jax():
    for mult, n in ((3, 4), ([5], 3), ([1, 2, 3, 4], 2)):
        assert port_schedule.normalize_multipliers(mult, n) == jax_schedule.normalize_multipliers(mult, n)
    for s in ("1,2", "0"):
        for skip in (True, False):
            a = port_schedule.InterpolationStateList.from_string(s, skip)
            b = jax_schedule.InterpolationStateList.from_string(s, skip)
            assert [a.is_frame_skipped(i) for i in range(4)] == [b.is_frame_skipped(i) for i in range(4)]
    with pytest.raises(ValueError):
        port_schedule.plan_window4(3)
