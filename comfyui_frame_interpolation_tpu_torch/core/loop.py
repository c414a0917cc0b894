"""Batched plan executor (port of the JAX package's ``core/loop.py``).

The expanded :class:`~.schedule.Plan` runs level by level: every task in a
DAG level is independent, so tasks are gathered into ``[B, H, W, C]`` batches
and the model is called once per batch with a ``[B]`` timestep vector.

:func:`run_plan_pair_cached` runs a flat timestep plan with a split model:
the timestep-independent half once per endpoint pair, the per-timestep half
once per timestep (M2M, GMFSS, EISAI, XVFI).

:func:`run_plan_window4` runs a 4-frame sliding-window plan (STMFNet, FLAVR).

Each executor has two modes, as in the JAX package. A clip whose inputs,
outputs and working batches fit the memory budget runs **resident**: frames
stay on their device for the whole plan and nothing goes back to the host
between tasks. A longer clip runs **streaming**, with the same chunking,
padding and batch shapes, so the model sees the same batches and gives the
same results: originals come through a bounded LRU on the model's device
(:class:`_OrigLRU`; a clip on the card is read in place, a clip on the host,
the way to stream one that does not fit the card, is copied there a frame
at a time), each produced frame starts its device-to-host copy as soon as it
exists (:class:`_StreamOut`), and its device buffer is released once its
last consumer has run. The result then comes back as a CPU tensor.

The budget is ``memory_budget_bytes`` when given, else the free device
memory (``torch.cuda.mem_get_info``) for CUDA frames; CPU frames with no
explicit budget run resident.

Each executor runs inside ``utils.profiling.maybe_profile``: with
``CFI_PROFILE=<dir>`` set, a ``torch.profiler`` trace of the run lands in
``<dir>/<executor's name>``.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..utils.profiling import maybe_profile
from .schedule import Plan, Source, Task

__all__ = ["run_plan", "run_plan_pair_cached", "run_plan_window4"]


def _profiled(fn):
    """Run the executor inside the optional ``CFI_PROFILE`` trace, tagged
    with its name (``utils.profiling``)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with maybe_profile(fn.__name__):
            return fn(*args, **kwargs)

    return wrapper


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


def _max_resident(
    frames: torch.Tensor, plan: Plan, batch_size: int, memory_budget_bytes: Optional[int], frames_per_task: int,
    floor: int,
) -> Optional[int]:
    """``None`` when the clip runs resident; else the LRU's size for the
    streaming mode. The JAX package's estimate: the inputs, the outputs and
    ``frames_per_task`` frames per task of a batch, against the budget
    (``memory_budget_bytes``, else the free device memory for CUDA frames;
    CPU frames with no budget run resident); the LRU holds a quarter of the
    budget's frames, and at least ``floor``."""
    n, h, w, c = frames.shape
    budget = memory_budget_bytes
    if budget is None and frames.is_cuda:
        budget = torch.cuda.mem_get_info(frames.device)[0]
    frame_bytes = h * w * c * frames.element_size()
    resident_estimate = (n + len(plan.output) + frames_per_task * batch_size) * frame_bytes
    if budget is None or resident_estimate <= budget:
        return None
    return max(floor, budget // (4 * frame_bytes))


class _OrigLRU:
    """The original frames for the batches, on the device the model runs on:
    at most ``max_resident`` of them, copied from the clip on first use and
    dropped least recently used first (consecutive pairs and windows share
    frames, so most lookups hit). The device is the clip's until the first
    model call returns, then that of its outputs (:meth:`follow`): a clip on
    the host with a model on the card has its frames copied there once per
    stay in the cache, not at every call. A clip already on that device is
    read in place, so the cache then holds views and costs no memory."""

    def __init__(self, frames: torch.Tensor, max_resident: int):
        self.frames = frames
        self.device = frames.device
        self.max_resident = max_resident
        self.cache: Dict[int, torch.Tensor] = {}
        self.lru: List[int] = []

    def follow(self, device: torch.device) -> None:
        if device != self.device:
            self.device = device
            self.cache.clear()
            self.lru.clear()

    def get(self, idx: int) -> torch.Tensor:
        if idx in self.cache:
            self.lru.remove(idx)
            self.lru.append(idx)
            return self.cache[idx]
        arr = self.frames[idx].to(self.device, non_blocking=True)
        self.cache[idx] = arr
        self.lru.append(idx)
        while len(self.cache) > self.max_resident:
            del self.cache[self.lru.pop(0)]
        return arr


class _StreamOut:
    """Device-to-host collector of produced frames. :meth:`add` starts a
    frame's copy at once (``non_blocking`` into pinned memory, a CUDA event
    recorded after it); :meth:`flush` and :meth:`materialize` wait on that
    event before the host copy is read (before it, the pinned buffer may
    still hold stale bytes), then keep a pageable copy, so the pinned
    buffers go back to the allocator and their number stays bounded by the
    copies in flight."""

    def __init__(self):
        self.in_flight: List[Tuple[int, torch.Tensor, Optional[torch.cuda.Event]]] = []
        self.host: Dict[int, torch.Tensor] = {}

    def add(self, task_id: int, arr: torch.Tensor) -> None:
        done = None
        if arr.is_cuda:
            host = torch.empty(arr.shape, dtype=arr.dtype, pin_memory=True)
            host.copy_(arr, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(arr.device))
            arr = host
        self.in_flight.append((task_id, arr, done))

    def _land(self, task_id: int, host: torch.Tensor, done: Optional[torch.cuda.Event]) -> None:
        if done is not None:
            done.synchronize()
            host = host.clone()
        self.host[task_id] = host

    def flush(self, keep_last: int = 0) -> None:
        """Land the oldest copies until at most ``keep_last`` are in flight."""
        while len(self.in_flight) > keep_last:
            self._land(*self.in_flight.pop(0))

    def materialize(self, task_id: int) -> torch.Tensor:
        """The host copy of one produced frame, landing its copy first if it
        is still in flight."""
        if task_id not in self.host:
            for i, entry in enumerate(self.in_flight):
                if entry[0] == task_id:
                    self._land(*self.in_flight.pop(i))
                    break
        return self.host[task_id]


def _assemble(frames: torch.Tensor, outs: _StreamOut, plan: Plan, out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The streamed result on the host: originals copied from the clip,
    produced frames from their host copies, in plan order."""
    out = torch.empty((len(plan.output), *frames.shape[1:]), dtype=out_dtype or frames.dtype)
    for i, (kind, idx) in enumerate(plan.output):
        out[i] = frames[idx] if kind == "orig" else outs.host[idx]
    return out


def _consumer_counts(plan: Plan) -> Dict[int, int]:
    """For each produced frame that later tasks read, the number of reads."""
    consumers: Dict[int, int] = {}
    for task in plan.tasks:
        for kind, idx in (task.src0, task.src1):
            if kind == "task":
                consumers[idx] = consumers.get(idx, 0) + 1
    return consumers


def _chunk_sources(chunk: List[Task], batch_size: int) -> Tuple[List[Source], List[Source], List[float]]:
    """A chunk's endpoints and timesteps, padded to ``batch_size`` with copies
    of its first task."""
    pad = batch_size - len(chunk)
    src0 = [t.src0 for t in chunk] + [chunk[0].src0] * pad
    src1 = [t.src1 for t in chunk] + [chunk[0].src1] * pad
    ts = [t.t if t.t is not None else 0.5 for t in chunk]
    return src0, src1, ts + [ts[0]] * pad


@_profiled
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

    Returns the assembled ``[n_outputs, H, W, C]`` sequence: on the frames'
    device when the clip runs resident, on the host when the resident
    estimate (inputs, outputs and four frames per task of a batch) exceeds
    the budget and it streams (:func:`_run_plan_streaming`), with the same
    values.
    """
    max_resident = _max_resident(frames, plan, batch_size, memory_budget_bytes, 4, 2 * batch_size + 2)
    if max_resident is not None:
        return _run_plan_streaming(frames, plan, model_fn, batch_size, out_dtype, max_resident)
    produced: Dict[int, torch.Tensor] = {}
    progress = _Progress("run_plan", len(plan.tasks))

    for li, level in enumerate(plan.levels):
        for start in range(0, len(level), batch_size):
            chunk: List[Task] = level[start : start + batch_size]
            src0, src1, ts = _chunk_sources(chunk, batch_size)
            f0 = _gather(frames, produced, src0)
            f1 = _gather(frames, produced, src1)
            tvec = torch.tensor(ts, dtype=frames.dtype, device=frames.device)
            mids = model_fn(f0, f1, tvec)
            for i, task in enumerate(chunk):
                produced[task.id] = mids[i]
            progress.step(len(chunk), li)

    out = _gather(frames, produced, plan.output)
    progress.finish(len(plan.output))
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out


def _run_plan_streaming(
    frames: torch.Tensor,
    plan: Plan,
    model_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    batch_size: int,
    out_dtype: Optional[torch.dtype],
    max_resident: int,
) -> torch.Tensor:
    """:func:`run_plan` with a bounded device footprint, for long clips: at
    most ``max_resident`` originals on the model's device (:class:`_OrigLRU`),
    each produced frame copied back as soon as it exists and its device
    buffer released once its last consumer has run (recursive and bisection
    plans), one chunk of copies left in flight to overlap the next chunk's
    compute. The chunking, padding and batch shapes are the resident path's,
    so the results are equal."""
    consumers = _consumer_counts(plan)
    dev_produced: Dict[int, torch.Tensor] = {}  # still read by later tasks
    orig = _OrigLRU(frames, max_resident)
    outs = _StreamOut()

    def get_src(src: Source) -> torch.Tensor:
        kind, idx = src
        if kind == "orig":
            return orig.get(idx)
        if idx in dev_produced:
            return dev_produced[idx]
        # read after its buffer was released (the counts rule it out): the host copy
        return outs.materialize(idx).to(orig.device)

    progress = _Progress("run_plan[streaming]", len(plan.tasks))
    for li, level in enumerate(plan.levels):
        for start in range(0, len(level), batch_size):
            chunk: List[Task] = level[start : start + batch_size]
            src0, src1, ts = _chunk_sources(chunk, batch_size)
            f0 = torch.stack([get_src(s) for s in src0])
            f1 = torch.stack([get_src(s) for s in src1])
            tvec = torch.tensor(ts, dtype=frames.dtype, device=orig.device)
            mids = model_fn(f0, f1, tvec)
            orig.follow(mids.device)
            progress.step(len(chunk), li)
            for i, task in enumerate(chunk):
                outs.add(task.id, mids[i])
                if consumers.get(task.id, 0) > 0:
                    dev_produced[task.id] = mids[i]
            for task in chunk:  # release the buffers whose consumers have all run
                for kind, idx in (task.src0, task.src1):
                    if kind == "task":
                        consumers[idx] -= 1
                        if consumers[idx] == 0:
                            dev_produced.pop(idx, None)
            outs.flush(keep_last=batch_size)
    outs.flush()
    progress.finish(len(plan.output))
    return _assemble(frames, outs, plan, out_dtype)


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


@_profiled
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

    Over the budget (the estimate of :func:`run_plan`) it streams
    (:func:`_run_plan_pair_cached_streaming`) and returns a host tensor."""
    if any(t.depth != 0 for t in plan.tasks):
        raise ValueError("run_plan_pair_cached runs flat (single-level) plans only")
    max_resident = _max_resident(frames, plan, batch_size, memory_budget_bytes, 4, 2 * batch_size + 2)
    if max_resident is not None:
        return _run_plan_pair_cached_streaming(frames, plan, reuse_fn, infer_fn, batch_size, out_dtype, max_resident)
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


def _run_plan_pair_cached_streaming(
    frames: torch.Tensor,
    plan: Plan,
    reuse_fn: Callable[[torch.Tensor, torch.Tensor], Any],
    infer_fn: Callable[[torch.Tensor, torch.Tensor, Any, torch.Tensor], torch.Tensor],
    batch_size: int,
    out_dtype: Optional[torch.dtype],
    max_resident: int,
) -> torch.Tensor:
    """:func:`run_plan_pair_cached` with a bounded device footprint: the
    grouping, chunking and batch shapes of the resident path, a chunk's pair
    cache alive only for its timestep loop, and the copies landed inside
    that loop, so at most two chunks of outputs are in flight."""
    orig = _OrigLRU(frames, max_resident)
    outs = _StreamOut()
    groups, by_count = _pair_groups(plan)

    progress = _Progress("run_plan[pair-cached,streaming]", len(plan.tasks))
    for m, keys in sorted(by_count.items()):
        for start in range(0, len(keys), batch_size):
            chunk = keys[start : start + batch_size]
            k = len(chunk)
            pad = batch_size - k
            padded = chunk + [chunk[0]] * pad
            # flat plans: every endpoint is an original frame
            f0 = torch.stack([orig.get(key[0][1]) for key in padded])
            f1 = torch.stack([orig.get(key[1][1]) for key in padded])
            cache = reuse_fn(f0, f1)
            for j in range(m):
                ts = [groups[key][j].t for key in chunk]
                ts = [0.5 if t is None else t for t in ts]
                tvec = torch.tensor(ts + [ts[0]] * pad, dtype=frames.dtype, device=orig.device)
                mids = infer_fn(f0, f1, cache, tvec)
                for i, key in enumerate(chunk):
                    outs.add(groups[key][j].id, mids[i])
                # land copies inside the timestep loop: a multiplier-m pair
                # would otherwise hold m * batch outputs on the device
                outs.flush(keep_last=batch_size)
                progress.step(k, 0)
            orig.follow(mids.device)
    outs.flush()
    progress.finish(len(plan.output))
    return _assemble(frames, outs, plan, out_dtype)


def _window_starts(chunk: List[Task], batch_size: int) -> List[int]:
    return [t.pair for t in chunk] + [chunk[0].pair] * (batch_size - len(chunk))


@_profiled
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

    Over the budget (the JAX estimate of five frames per window: the four
    inputs and the output) it streams (:func:`_run_plan_window4_streaming`)
    and returns a host tensor."""
    max_resident = _max_resident(frames, plan, batch_size, memory_budget_bytes, 5, 4 * batch_size + 4)
    if max_resident is not None:
        return _run_plan_window4_streaming(frames, plan, model_fn, batch_size, out_dtype, max_resident)
    produced: Dict[int, torch.Tensor] = {}
    tasks = plan.tasks
    progress = _Progress("run_plan_window4", len(tasks))
    for start in range(0, len(tasks), batch_size):
        chunk = tasks[start : start + batch_size]
        idx = torch.tensor(_window_starts(chunk, batch_size), dtype=torch.long, device=frames.device)
        mids = model_fn(*(frames.index_select(0, idx + k) for k in range(4)))
        for i, task in enumerate(chunk):
            produced[task.id] = mids[i]
        progress.step(len(chunk), 0)
    out = _gather(frames, produced, plan.output)
    progress.finish(len(plan.output))
    if out_dtype is not None:
        out = out.to(out_dtype)
    return out


def _run_plan_window4_streaming(
    frames: torch.Tensor,
    plan: Plan,
    model_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    batch_size: int,
    out_dtype: Optional[torch.dtype],
    max_resident: int,
) -> torch.Tensor:
    """:func:`run_plan_window4` with a bounded device footprint: the
    resident path's chunking and batch shapes, the originals through the LRU
    (consecutive windows share three frames, so it hits), the outputs copied
    back as they come."""
    orig = _OrigLRU(frames, max_resident)
    outs = _StreamOut()
    tasks = plan.tasks
    progress = _Progress("run_plan_window4[streaming]", len(tasks))
    for start in range(0, len(tasks), batch_size):
        chunk = tasks[start : start + batch_size]
        starts = _window_starts(chunk, batch_size)
        mids = model_fn(*(torch.stack([orig.get(p + k) for p in starts]) for k in range(4)))
        orig.follow(mids.device)
        for i, task in enumerate(chunk):
            outs.add(task.id, mids[i])
        outs.flush(keep_last=batch_size)
        progress.step(len(chunk), 0)
    outs.flush()
    progress.finish(len(plan.output))
    return _assemble(frames, outs, plan, out_dtype)
