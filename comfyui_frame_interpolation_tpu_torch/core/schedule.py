"""Interpolation schedule expansion — the replacement for the reference's
per-pair Python frame loops. A copy of the JAX package's pure-Python
``core/schedule.py`` (that package's ``__init__`` imports jax, so the port
cannot import it from there).

The reference (``vfi_utils.py:149-389`` plus the per-node loops in
``vfi_models/{rife,film,stmfnet,flavr,atm,momo}/__init__.py``) interleaves schedule
decisions with device execution: a Python loop walks frame pairs, calls the model one
timestep at a time, and appends results to a CPU list. That structure defeats
batching and keeps the device idle between tiny dispatches.

Here the schedule is *fully expanded host-side* into a static, data-independent plan:

* a list of :class:`Task` nodes — one per model invocation — forming a DAG whose only
  edges are "this task's endpoint is another task's output" (recursive-midpoint and
  bisection modes), and
* an ``output`` list describing how original frames and task outputs concatenate into
  the final frame sequence.

Tasks are grouped into ``levels`` by DAG depth: every task in a level is independent,
so the executor can stack them into one batched model call. Level 0 holds all
(pair, t) tasks whose endpoints are original frames — for plain timestep models
(RIFE & friends) that is the *entire* plan, i.e. one flat batch dimension.

Behavioral parity notes (semantics replicated from the reference):

* ``plan_timestep`` — ``vfi_utils.py:199-211`` (t = i/m for i in 1..m-1),
  ``vfi_utils.py:364-388`` (list multipliers right-padded with 2; ``m == 0`` drops the
  pair *including* its leading original frame; per-pair sub-sequences are trimmed of
  their trailing frame except for the final pair — so an ``m == 0`` on the final pair
  drops the clip's last frame, as in the reference).
* ``plan_midpoint`` — ``vfi_utils.py:162-171`` recursive binary subdivision with the
  middle frame emitted between the halves only when ``n`` is odd.
* ``plan_bisection`` — ``vfi_models/film/__init__.py:12-42``: repeatedly insert the
  remaining split point whose position is closest to the center of an existing gap;
  ``dt`` is the point's position relative to that gap. Skipped pairs contribute
  nothing (not even their leading frame — unlike the generic loop).
* ``plan_window4`` — ``vfi_models/stmfnet/__init__.py:58-83``: slide a 4-frame window,
  interpolate between the middle two, with first/last frame framing and optional
  duplication; a window is skipped only if pair ``i`` *and* ``i+1`` are both skipped.
* ``InterpolationStateList`` — ``vfi_utils.py:49-57`` (skip-list vs keep-list).

Known divergence (deliberate): in the reference's list-multiplier path every per-pair
sub-loop consults ``is_frame_skipped(0)`` because the frames are sliced before the loop
(``vfi_utils.py:371-377``), so skip states are mis-indexed. We consult the *global*
pair index instead, which matches the int-multiplier path's behavior.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple, Union

__all__ = [
    "InterpolationStateList",
    "Task",
    "Plan",
    "normalize_multipliers",
    "plan_timestep",
    "plan_midpoint",
    "plan_bisection",
    "plan_window4",
]

# A source for a task endpoint or an output slot:
#   ("orig", frame_index)  — an original input frame
#   ("task", task_id)      — the output of another task
Source = Tuple[str, int]


class InterpolationStateList:
    """Skip/keep-list over frame-pair indices (reference ``vfi_utils.py:49-57``).

    ``is_skip_list=True``: listed pair indices are skipped.
    ``is_skip_list=False``: only listed pair indices are interpolated.
    """

    def __init__(self, frame_indices: Sequence[int], is_skip_list: bool):
        self.frame_indices = list(frame_indices)
        self.is_skip_list = bool(is_skip_list)

    def is_frame_skipped(self, frame_index: int) -> bool:
        in_list = frame_index in self.frame_indices
        return (self.is_skip_list and in_list) or (not self.is_skip_list and not in_list)

    @classmethod
    def from_string(cls, frame_indices: str, is_skip_list: bool) -> "InterpolationStateList":
        """Parse "1,2,3" — reference ``MakeInterpolationStateList`` (vfi_utils.py:60-81)."""
        return cls([int(s) for s in frame_indices.split(",")], is_skip_list)


@dataclasses.dataclass(frozen=True)
class Task:
    """One model invocation producing one intermediate frame."""

    id: int
    pair: int  # global frame-pair index (frame `pair` .. frame `pair+1`)
    t: Optional[float]  # timestep in (0,1); None for midpoint-mode models (no t input)
    src0: Source
    src1: Source
    depth: int  # DAG level; 0 = both endpoints are original frames


@dataclasses.dataclass
class Plan:
    """A fully expanded interpolation schedule."""

    n_frames: int
    tasks: List[Task]
    output: List[Source]

    @property
    def levels(self) -> List[List[Task]]:
        """Tasks grouped by DAG depth (each level is independently batchable)."""
        if not self.tasks:
            return []
        depth = 1 + max(t.depth for t in self.tasks)
        levels: List[List[Task]] = [[] for _ in range(depth)]
        for t in self.tasks:
            levels[t.depth].append(t)
        return levels

    @property
    def n_outputs(self) -> int:
        return len(self.output)


def normalize_multipliers(
    multiplier: Union[int, Sequence[int]], n_pairs: int
) -> List[int]:
    """Normalize an int or per-pair list multiplier to one int per pair.

    Lists shorter than ``n_pairs`` are right-padded with 2 and longer ones truncated
    (reference ``vfi_utils.py:364-366``; extra entries are never read there either).
    """
    if isinstance(multiplier, (int,)) and not isinstance(multiplier, bool):
        return [int(multiplier)] * n_pairs
    ms = [int(m) for m in multiplier]
    ms += [2] * (n_pairs - len(ms))
    return ms[:n_pairs]


def _skipped(states: Optional[InterpolationStateList], pair: int) -> bool:
    return states is not None and states.is_frame_skipped(pair)


# ---------------------------------------------------------------------------
# Timestep mode (generic loop + RIFE task loop)
# ---------------------------------------------------------------------------


def plan_timestep(
    n_frames: int,
    multiplier: Union[int, Sequence[int]],
    states: Optional[InterpolationStateList] = None,
    zero_drops_pair: bool = True,
) -> Plan:
    """Expand the timestep-mode schedule used by the generic frame loop and RIFE.

    Per non-skipped pair ``i`` with multiplier ``m``: emit frame ``i`` followed by
    intermediate frames at ``t = k/m`` for ``k`` in ``1..m-1``. Skipped pairs emit
    frame ``i`` alone. A trailing original frame closes the sequence — except for the
    reference's list-mode quirk where ``m == 0`` drops the pair entirely (and drops
    the clip-final frame when it lands on the last pair).

    ``zero_drops_pair``: the generic loop (``vfi_utils.py:370``) drops ``m == 0``
    pairs including their leading frame; RIFE's own task loop
    (``rife/__init__.py:170-174,225-230``) instead emits the frame with no
    intermediates — pass ``False`` for RIFE-node semantics.
    """
    if n_frames < 2:
        raise ValueError(f"need at least 2 frames, got {n_frames}")
    n_pairs = n_frames - 1
    is_list = not isinstance(multiplier, int) or isinstance(multiplier, bool)
    ms = normalize_multipliers(multiplier, n_pairs)

    tasks: List[Task] = []
    output: List[Source] = []
    for pair in range(n_pairs):
        m = ms[pair]
        if is_list and m == 0 and zero_drops_pair:
            # Reference list-mode: `if multiplier == 0: continue` (vfi_utils.py:370)
            # drops the pair including its leading frame; if this is the last pair the
            # final frame is dropped too (the previous pair's sequence was trimmed).
            continue
        output.append(("orig", pair))
        if _skipped(states, pair) or m <= 1:
            continue
        for k in range(1, m):
            tid = len(tasks)
            tasks.append(
                Task(tid, pair, k / m, ("orig", pair), ("orig", pair + 1), depth=0)
            )
            output.append(("task", tid))
    if not (is_list and ms[-1] == 0 and zero_drops_pair):
        output.append(("orig", n_frames - 1))
    return Plan(n_frames, tasks, output)


# ---------------------------------------------------------------------------
# Recursive-midpoint mode (CAIN, Sepconv — models without a t input)
# ---------------------------------------------------------------------------


def plan_midpoint(
    n_frames: int,
    multiplier: Union[int, Sequence[int]],
    states: Optional[InterpolationStateList] = None,
) -> Plan:
    """Expand the recursive binary-subdivision schedule (``vfi_utils.py:162-171``).

    For each pair, ``n = m - 1`` intermediates are produced by computing the midpoint
    and recursing on each half with ``n // 2``; the midpoint itself is emitted between
    the halves only when ``n`` is odd (but always *computed*, since it is the shared
    endpoint of both halves).
    """
    if n_frames < 2:
        raise ValueError(f"need at least 2 frames, got {n_frames}")
    n_pairs = n_frames - 1
    is_list = not isinstance(multiplier, int) or isinstance(multiplier, bool)
    ms = normalize_multipliers(multiplier, n_pairs)

    tasks: List[Task] = []
    output: List[Source] = []

    def rec(pair: int, src0: Source, src1: Source, n: int, depth: int) -> List[Source]:
        tid = len(tasks)
        tasks.append(Task(tid, pair, None, src0, src1, depth))
        mid: Source = ("task", tid)
        if n == 1:
            return [mid]
        first = rec(pair, src0, mid, n // 2, depth + 1)
        second = rec(pair, mid, src1, n // 2, depth + 1)
        if n % 2:
            return [*first, mid, *second]
        return [*first, *second]

    for pair in range(n_pairs):
        m = ms[pair]
        if is_list and m == 0:
            continue
        output.append(("orig", pair))
        if _skipped(states, pair) or m <= 1:
            continue
        output.extend(rec(pair, ("orig", pair), ("orig", pair + 1), m - 1, 0))
    if not (is_list and ms[-1] == 0):
        output.append(("orig", n_frames - 1))
    return Plan(n_frames, tasks, output)


# ---------------------------------------------------------------------------
# Bisection mode (FILM / ATM / MoMo)
# ---------------------------------------------------------------------------


def plan_bisection(
    n_frames: int,
    multiplier: Union[int, Sequence[int]],
    states: Optional[InterpolationStateList] = None,
) -> Plan:
    """Expand the FILM-style timeline-bisection schedule
    (``vfi_models/film/__init__.py:12-42``).

    Per pair with ``inter = m - 1`` intermediates: split points ``k/(inter+1)`` are
    inserted one at a time, each time choosing the (existing gap, remaining point)
    combination whose relative position within the gap is closest to ``0.5``; the
    model is called with endpoints = the gap's current frames and
    ``dt = (point - gap_start) / (gap_end - gap_start)``.

    Emission: for each non-skipped pair, ``[frame_i, mids in timeline order]``
    (``results[:-1]``); skipped pairs contribute *nothing*; the clip's final frame is
    always appended (``film/__init__.py:89-106``).
    """
    if n_frames < 2:
        raise ValueError(f"need at least 2 frames, got {n_frames}")
    n_pairs = n_frames - 1
    ms = normalize_multipliers(multiplier, n_pairs)

    tasks: List[Task] = []
    output: List[Source] = []

    for pair in range(n_pairs):
        if _skipped(states, pair):
            continue
        output.append(("orig", pair))
        inter = ms[pair] - 1
        if inter <= 0:
            continue
        # timeline state: positions (exact fractions) and their sources/depths
        splits = [Fraction(k, inter + 1) for k in range(inter + 2)]
        idxes = [0, inter + 1]
        sources: List[Source] = [("orig", pair), ("orig", pair + 1)]
        depths = [-1, -1]
        remains = list(range(1, inter + 1))

        for _ in range(len(remains)):
            # pick (gap, remaining point) minimizing |relpos - 1/2|, row-major argmin
            best = None
            for gi in range(len(idxes) - 1):
                s, e = splits[idxes[gi]], splits[idxes[gi + 1]]
                for ri, r in enumerate(remains):
                    d = abs((splits[r] - s) / (e - s) - Fraction(1, 2))
                    if best is None or d < best[0]:
                        best = (d, gi, ri)
            _, gi, ri = best
            r = remains[ri]
            s, e = splits[idxes[gi]], splits[idxes[gi + 1]]
            dt = (splits[r] - s) / (e - s)
            depth = 1 + max(depths[gi], depths[gi + 1])
            tid = len(tasks)
            tasks.append(
                Task(tid, pair, float(dt), sources[gi], sources[gi + 1], depth)
            )
            # insert at position gi+1 (bisect_left over sorted idxes)
            idxes.insert(gi + 1, r)
            sources.insert(gi + 1, ("task", tid))
            depths.insert(gi + 1, depth)
            del remains[ri]

        # results[:-1] == [frame_i, mids...]; sources[1:-1] are mids in timeline order
        output.extend(sources[1:-1])
    output.append(("orig", n_frames - 1))
    return Plan(n_frames, tasks, output)


# ---------------------------------------------------------------------------
# 4-frame sliding window (STMFNet / FLAVR, 2x only)
# ---------------------------------------------------------------------------


def plan_window4(
    n_frames: int,
    duplicate_first_last_frames: bool = False,
    states: Optional[InterpolationStateList] = None,
) -> Plan:
    """Expand the 4-frame sliding-window 2x schedule
    (``vfi_models/stmfnet/__init__.py:58-83``).

    Window ``i`` consumes frames ``(i, i+1, i+2, i+3)`` and produces one frame between
    ``i+1`` and ``i+2``. A window is skipped only when pairs ``i`` and ``i+1`` are both
    skipped. The first window additionally emits frames ``i`` (optionally doubled) and
    ``i+1``; every window emits its new frame then frame ``i+2``; the last window also
    emits frame ``i+3`` (optionally doubled).

    Window tasks carry their window start in ``pair`` and ``src0/src1`` point at the
    two *middle* frames; the executor fetches the full window from ``pair``.
    """
    if n_frames < 4:
        raise ValueError(f"4-frame window models require >= 4 frames, got {n_frames}")
    tasks: List[Task] = []
    output: List[Source] = []
    for i in range(n_frames - 3):
        if (
            states is not None
            and states.is_frame_skipped(i)
            and states.is_frame_skipped(i + 1)
        ):
            continue
        tid = len(tasks)
        tasks.append(Task(tid, i, 0.5, ("orig", i + 1), ("orig", i + 2), depth=0))
        if i == 0:
            output.append(("orig", 0))
            if duplicate_first_last_frames:
                output.append(("orig", 0))
            output.append(("orig", 1))
        output.append(("task", tid))
        output.append(("orig", i + 2))
        if i == n_frames - 4:
            output.append(("orig", i + 3))
            if duplicate_first_last_frames:
                output.append(("orig", i + 3))
    return Plan(n_frames, tasks, output)
