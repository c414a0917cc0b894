"""Optional ``torch.profiler`` hook, port of the JAX package's
``utils/profiling.py``.

Set ``CFI_PROFILE=<dir>`` to trace any executor run (``core.loop.run_plan``
and the other two) into ``<dir>/<tag>``: CPU ops and, when a card is
present, its kernels, as a Chrome trace (``<host>.<pid>.<ns>.pt.trace.json``;
open it in Perfetto or ``chrome://tracing``).

With the variable unset the hook only reads it: no profiler runs.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Iterator, Optional

import torch

__all__ = ["maybe_profile", "profiling_enabled"]

_active = False


def profiling_enabled() -> bool:
    return bool(os.environ.get("CFI_PROFILE"))


@contextlib.contextmanager
def maybe_profile(tag: Optional[str] = None) -> Iterator[None]:
    """Trace the region with ``torch.profiler`` into ``CFI_PROFILE[/tag]``
    when ``CFI_PROFILE`` is set; no-op otherwise. A nested call inside a
    traced region does not start a second trace."""
    global _active
    base = os.environ.get("CFI_PROFILE")
    if not base or _active:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(base, tag) if tag else base
    os.makedirs(path, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    _active = True
    try:
        with profile(activities=activities) as prof:
            try:
                yield
            finally:
                if cuda:
                    torch.cuda.synchronize()  # the region's kernels end inside the trace
        prof.export_chrome_trace(os.path.join(path, f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.pt.trace.json"))
    finally:
        _active = False
