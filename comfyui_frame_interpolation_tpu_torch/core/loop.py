"""Batched plan executor (port of the JAX package's ``core/loop.py``,
resident mode).

The expanded :class:`~.schedule.Plan` runs level by level: every task in a
DAG level is independent, so tasks are gathered into ``[B, H, W, C]`` batches
and the model is called once per batch with a ``[B]`` timestep vector. Frames
stay on the device for the whole plan; nothing goes back to the host between
tasks.

:func:`run_plan_pair_cached` runs a flat timestep plan with a split model:
the timestep-independent half once per endpoint pair, the per-timestep half
once per timestep (M2M, GMFSS, EISAI; XVFI when it is ported).

:func:`run_plan_window4` runs a 4-frame sliding-window plan (STMFNet, FLAVR).

Only the resident mode is ported. A clip whose inputs, outputs and working
batches would not fit the memory budget raises; the streaming executors wait
in ``ROADMAP.md`` Queue 1.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .schedule import Plan, Source, Task

__all__ = ["run_plan", "run_plan_pair_cached", "run_plan_window4"]


class _Progress:
    """Opt-in executor progress (``CFI_PROGRESS=1``): per-level counts and
    throughput, the analog of the reference's per-pair prints
    (``vfi_utils.py:295-298,326-336``)."""

    def __init__(self, what: str, n_tasks: int):
        self.enabled = os.environ.get("CFI_PROGRESS", "") == "1"
        self.what = what
        self.n_tasks = n_tasks
        self.done = 0
        if self.enabled:
            self.t0 = time.perf_counter()
            print(f"CFI-VFI: {what}: {n_tasks} interpolation tasks")

    def step(self, n: int, level: int) -> None:
        if not self.enabled:
            return
        self.done += n
        dt = time.perf_counter() - self.t0
        fps = self.done / dt if dt > 0 else float("inf")
        print(f"CFI-VFI: level {level}: {self.done}/{self.n_tasks} frames ({fps:.2f} frames/s)")

    def finish(self, n_out: int) -> None:
        if self.enabled:
            dt = time.perf_counter() - self.t0
            print(f"CFI-VFI done! {self.done} frames generated ({n_out} total) in {dt:.2f}s")


def _gather(
    frames: torch.Tensor, produced: Dict[int, torch.Tensor], sources: Sequence[Source]
) -> torch.Tensor:
    """Stack a batch of frames addressed by plan sources: runs of original
    frames with one ``index_select`` on the device-resident clip, task outputs
    from the produced map."""
    parts: List[torch.Tensor] = []
    orig_idx: List[int] = []

    def flush():
        if orig_idx:
            idx = torch.tensor(orig_idx, dtype=torch.long, device=frames.device)
            parts.append(frames.index_select(0, idx))
            orig_idx.clear()

    for kind, idx in sources:
        if kind == "orig":
            orig_idx.append(idx)
        else:
            flush()
            parts.append(produced[idx][None])
    flush()
    return parts[0] if len(parts) == 1 else torch.cat(parts, 0)


def _check_resident(
    what: str, frames: torch.Tensor, plan: Plan, batch_size: int, memory_budget_bytes: Optional[int],
    frames_per_task: int = 4,
) -> None:
    """Raise ``MemoryError`` when the clip's inputs, outputs and working
    batches (``frames_per_task`` frames per task of a batch) would not fit
    the budget: ``memory_budget_bytes`` when given, else the free device
    memory (``torch.cuda.mem_get_info``) for CUDA frames; CPU frames with no
    explicit budget are not checked."""
    n, h, w, c = frames.shape
    budget = memory_budget_bytes
    if budget is None and frames.is_cuda:
        budget = torch.cuda.mem_get_info(frames.device)[0]
    frame_bytes = h * w * c * frames.element_size()
    resident_estimate = (n + len(plan.output) + frames_per_task * batch_size) * frame_bytes
    if budget is not None and resident_estimate > budget:
        raise MemoryError(
            f"{what}: {n} input + {len(plan.output)} output frames of {h}x{w}x{c} "
            f"at batch {batch_size} need about {resident_estimate / 2**30:.2f} GiB "
            f"resident, over the {budget / 2**30:.2f} GiB budget; the streaming "
            "executor is not ported yet (ROADMAP.md Queue 1): split the clip"
        )


def run_plan(
    frames: torch.Tensor,
    plan: Plan,
    model_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    batch_size: int = 8,
    out_dtype: Optional[torch.dtype] = None,
    memory_budget_bytes: Optional[int] = None,
) -> torch.Tensor:
    """Execute ``plan`` over NHWC ``frames`` (on the device the model runs on)
    with a batched model.

    ``model_fn(f0, f1, t) -> mid`` takes ``[B, H, W, C]`` endpoint batches and
    a ``[B]`` timestep vector (ignored by midpoint-mode models) and returns
    ``[B, H, W, C]`` intermediate frames. Every call gets exactly
    ``batch_size`` tasks: a short last chunk is padded with copies of its
    first task, whose outputs are dropped.

    Over the memory budget (see :func:`_check_resident`) it raises
    ``MemoryError``. Returns the assembled
    ``[n_outputs, H, W, C]`` sequence on the frames' device.
    """
    _check_resident("run_plan", frames, plan, batch_size, memory_budget_bytes)
    produced: Dict[int, torch.Tensor] = {}
    progress = _Progress("run_plan", len(plan.tasks))

    for li, level in enumerate(plan.levels):
        for start in range(0, len(level), batch_size):
            chunk: List[Task] = level[start : start + batch_size]
            k = len(chunk)
            pad = batch_size - k
            src0 = [t.src0 for t in chunk] + [chunk[0].src0] * pad
            src1 = [t.src1 for t in chunk] + [chunk[0].src1] * pad
            ts = [t.t if t.t is not None else 0.5 for t in chunk]
            ts += [ts[0]] * pad
            f0 = _gather(frames, produced, src0)
            f1 = _gather(frames, produced, src1)
            tvec = torch.tensor(ts, dtype=frames.dtype, device=frames.device)
            mids = model_fn(f0, f1, tvec)
            for i, task in enumerate(chunk):
                produced[task.id] = mids[i]
            progress.step(k, li)

    out = _gather(frames, produced, plan.output)
    progress.finish(len(plan.output))
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out


def _pair_groups(plan: Plan) -> Tuple[Dict[tuple, List[Task]], Dict[int, List[tuple]]]:
    """Group a flat plan's tasks by endpoint pair (first-appearance order),
    and the pairs by their timestep count, so that every call of a bucket
    has the same shapes."""
    groups: Dict[tuple, List[Task]] = {}
    for task in plan.tasks:
        groups.setdefault((task.src0, task.src1), []).append(task)
    by_count: Dict[int, List[tuple]] = {}
    for key, tasks in groups.items():
        by_count.setdefault(len(tasks), []).append(key)
    return groups, by_count


def run_plan_pair_cached(
    frames: torch.Tensor,
    plan: Plan,
    reuse_fn: Callable[[torch.Tensor, torch.Tensor], Any],
    infer_fn: Callable[[torch.Tensor, torch.Tensor, Any, torch.Tensor], torch.Tensor],
    batch_size: int = 8,
    out_dtype: Optional[torch.dtype] = None,
    memory_budget_bytes: Optional[int] = None,
) -> torch.Tensor:
    """Execute a single-level (timestep-mode) plan with per-pair caching.

    ``reuse_fn(f0, f1) -> cache`` computes the timestep-independent state of
    a batch of pairs once; ``infer_fn(f0, f1, cache, t) -> mid`` produces
    each intermediate. A multiplier-m schedule thus runs the expensive pair
    analysis once instead of m-1 times (the reference recomputes it per
    timestep). Tasks are grouped by endpoint pair and the pairs bucketed by
    their timestep count; buckets run in ascending count, each in chunks of
    ``batch_size`` pairs, a short chunk padded with copies of its first pair
    (whose outputs are dropped). The same grouping, padding and call order
    as the JAX executor.

    Over the memory budget (see :func:`_check_resident`) it raises
    ``MemoryError``."""
    if any(t.depth != 0 for t in plan.tasks):
        raise ValueError("run_plan_pair_cached runs flat (single-level) plans only")
    _check_resident("run_plan_pair_cached", frames, plan, batch_size, memory_budget_bytes)
    produced: Dict[int, torch.Tensor] = {}
    groups, by_count = _pair_groups(plan)

    progress = _Progress("run_plan[pair-cached]", len(plan.tasks))
    for m, keys in sorted(by_count.items()):
        for start in range(0, len(keys), batch_size):
            chunk = keys[start : start + batch_size]
            k = len(chunk)
            pad = batch_size - k
            padded = chunk + [chunk[0]] * pad
            f0 = _gather(frames, produced, [key[0] for key in padded])
            f1 = _gather(frames, produced, [key[1] for key in padded])
            cache = reuse_fn(f0, f1)
            for j in range(m):
                ts = [groups[key][j].t for key in chunk]
                ts = [0.5 if t is None else t for t in ts]
                tvec = torch.tensor(ts + [ts[0]] * pad, dtype=frames.dtype, device=frames.device)
                mids = infer_fn(f0, f1, cache, tvec)
                for i, key in enumerate(chunk):
                    produced[groups[key][j].id] = mids[i]
                progress.step(k, 0)

    out = _gather(frames, produced, plan.output)
    progress.finish(len(plan.output))
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out


def run_plan_window4(
    frames: torch.Tensor,
    plan: Plan,
    model_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    batch_size: int = 4,
    out_dtype: Optional[torch.dtype] = None,
    memory_budget_bytes: Optional[int] = None,
) -> torch.Tensor:
    """Execute a :func:`~.schedule.plan_window4` plan over NHWC ``frames``.

    ``model_fn(f0, f1, f2, f3) -> mid`` takes ``[B, H, W, C]`` batches of the
    four frames of each window (window start = ``task.pair``) and returns
    the frame between ``f1`` and ``f2``. Windows run ``batch_size`` per call
    in plan order, a short last chunk padded with copies of its first window
    (whose outputs are dropped); each batch is four ``index_select`` calls on
    the device-resident clip. The same chunking and padding as the JAX
    executor.

    Over the memory budget (see :func:`_check_resident`, here with the JAX
    estimate of five frames per window: the four inputs and the output) it
    raises ``MemoryError``."""
    _check_resident("run_plan_window4", frames, plan, batch_size, memory_budget_bytes, frames_per_task=5)
    produced: Dict[int, torch.Tensor] = {}
    tasks = plan.tasks
    progress = _Progress("run_plan_window4", len(tasks))
    for start in range(0, len(tasks), batch_size):
        chunk = tasks[start : start + batch_size]
        starts = [t.pair for t in chunk] + [chunk[0].pair] * (batch_size - len(chunk))
        idx = torch.tensor(starts, dtype=torch.long, device=frames.device)
        mids = model_fn(*(frames.index_select(0, idx + k) for k in range(4)))
        for i, task in enumerate(chunk):
            produced[task.id] = mids[i]
        progress.step(len(chunk), 0)
    out = _gather(frames, produced, plan.output)
    progress.finish(len(plan.output))
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out
